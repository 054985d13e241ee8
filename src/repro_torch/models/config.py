"""ModelConfig: a single dataclass describing every assigned architecture
(the port's own copy of the reference dataclass, field for field).

``layer_pattern`` selects the super-block structure the layer scan uses:
  * "dense"        — uniform decoder blocks (attention + MLP)
  * "local_global" — period 2: sliding-window attn / global attn (gemma2)
  * "moe"          — uniform decoder blocks with MoE MLP (dbrx)
  * "moe_alt"      — period 2: dense MLP / MoE MLP (llama4-maverick)
  * "jamba"        — period 8: 7 mamba blocks + 1 attention block, MoE on
                     even in-block positions (jamba 1:7 interleave)
  * "rwkv"         — RWKV6 time-mix + channel-mix blocks (attention-free)
  * "encdec"       — whisper-style encoder-decoder
``frontend`` marks modality stubs ("audio", "vision", None): the launch-time
``input_specs`` provides precomputed frame/patch embeddings for these.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None           # default d_model // n_heads
    layer_pattern: str = "dense"
    # attention
    rope_theta: float = 10_000.0
    window: int = 4096                        # sliding window (local layers)
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    mrope_sections: Optional[Tuple[int, int, int]] = None   # qwen2-vl
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba) / RWKV
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    # enc-dec
    n_enc_layers: int = 0
    frontend: Optional[str] = None
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    tie_embeddings: bool = True
    gated_mlp: bool = True                    # False: GPT-style 2-matrix MLP
    # training-time attention implementation: "dense" | "sparse" (roaring)
    attn_impl: str = "dense"
    sparse_block: int = 128

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to 256 so logits shard cleanly on the model axis
        (standard vocab padding); padded slots are masked at the LM head."""
        return (self.vocab + 255) // 256 * 256

    @property
    def superblock(self) -> int:
        return {"dense": 1, "moe": 1, "rwkv": 1, "local_global": 2,
                "moe_alt": 2, "jamba": 8, "encdec": 1}[self.layer_pattern]

    @property
    def n_superblocks(self) -> int:
        assert self.n_layers % self.superblock == 0, (
            self.name, self.n_layers, self.superblock)
        return self.n_layers // self.superblock

    def block_kinds(self) -> list[str]:
        """Per-layer kind inside one super-block."""
        p = self.layer_pattern
        if p in ("dense", "encdec"):
            return ["attn_mlp"]
        if p == "moe":
            return ["attn_moe"]
        if p == "local_global":
            return ["attn_local_mlp", "attn_mlp"]
        if p == "moe_alt":
            return ["attn_mlp", "attn_moe"]
        if p == "jamba":
            # 7 mamba + 1 attn per super-block; MoE on even in-block positions
            # (0,2,4,6) -> 36 MoE layers at 72L, matching jamba-1.5's 398B
            kinds = []
            for i in range(7):
                kinds.append("mamba_moe" if i % 2 == 0 else "mamba_mlp")
            kinds.append("attn_mlp")
            return kinds
        if p == "rwkv":
            return ["rwkv"]
        raise ValueError(p)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for roofline math."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd, H, KVH = self.hd, self.n_heads, self.n_kv_heads
        attn = d * hd * (H + 2 * KVH) + H * hd * d
        n_mats = 3 if self.gated_mlp else 2
        mlp = n_mats * d * f
        moe = self.n_experts * n_mats * d * f
        d_in = self.ssm_expand * d
        mamba = (d * 2 * d_in                          # in_proj (x, z)
                 + d_in * self.ssm_conv                # conv
                 + d_in * (2 * self.ssm_state + 1)     # B, C, dt proj (approx)
                 + d_in * d)                           # out proj
        rwkv = 6 * d * d + 2 * d * f                   # time-mix + channel-mix
        total = v * d + (0 if self.tie_embeddings else v * d)
        for kind in [k for _ in range(self.n_superblocks) for k in self.block_kinds()]:
            if kind.startswith("attn"):
                total += attn
            if kind.startswith("mamba"):
                total += mamba
            if kind == "rwkv":
                total += rwkv
            if kind.endswith("_moe"):
                total += moe
            elif kind.endswith("_mlp") or kind == "attn_mlp":
                total += mlp
        if self.layer_pattern == "encdec":
            # encoder blocks + decoder cross-attention
            total += self.n_enc_layers * (attn + mlp)
            total += self.n_layers * attn             # cross-attn per dec layer
        return total

    def active_param_count(self) -> int:
        """Active-per-token parameters (MoE top-k instead of all experts)."""
        if self.n_experts == 0:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        n_mats = 3 if self.gated_mlp else 2
        inactive = (self.n_experts - self.top_k) * n_mats * d * f
        n_moe = sum(1 for _ in range(self.n_superblocks)
                    for k in self.block_kinds() if k.endswith("_moe"))
        return self.param_count() - n_moe * inactive
