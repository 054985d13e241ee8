"""Analytic FLOP/byte model per (architecture x shape) cell.

The port's own copy of the reference's analytic model (the same counts,
term for term). The reference cross-validates it against XLA's
``cost_analysis`` on fully unrolled reduced configs; the port reads it to
turn a measured step time into a FLOP rate and a share of the card's peak.

Conventions: one MAC = 2 FLOPs; softmax/norms/elementwise included at their
op counts; backward = 2x forward matmul FLOPs (param + activation grads).
"""

from __future__ import annotations

import dataclasses

from .config import ModelConfig


@dataclasses.dataclass
class FlopCount:
    matmul: float = 0.0
    attention: float = 0.0        # score + pv matmuls (separate: masks change it)
    elementwise: float = 0.0

    @property
    def total(self) -> float:
        return self.matmul + self.attention + self.elementwise

    def scaled(self, f: float) -> "FlopCount":
        return FlopCount(self.matmul * f, self.attention * f,
                         self.elementwise * f)

    def __add__(self, o: "FlopCount") -> "FlopCount":
        return FlopCount(self.matmul + o.matmul, self.attention + o.attention,
                         self.elementwise + o.elementwise)


def _attn_visible(S_q: int, S_kv: int, causal: bool, window) -> float:
    """Average visible kv positions per query row."""
    if not causal:
        vis = S_kv
    else:
        # rows aligned at the end: row i sees (S_kv - S_q + i + 1)
        vis = S_kv - S_q / 2 + 0.5
    if window is not None:
        vis = min(vis, window)
    return max(vis, 1.0)


def layer_flops(cfg: ModelConfig, kind: str, B: int, S_q: int, S_kv: int,
                decode: bool = False) -> FlopCount:
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    T = B * S_q                               # tokens processed
    fc = FlopCount()
    if kind.startswith("attn"):
        fc.matmul += 2 * T * d * hd * (H + 2 * KVH)       # qkv proj
        fc.matmul += 2 * T * H * hd * d                   # out proj
        causal = True
        window = cfg.window if "local" in kind else None
        vis = _attn_visible(S_q, S_kv, causal and not decode, window)
        if decode:
            vis = min(S_kv, window) if window else S_kv
        fc.attention += 2 * 2 * B * H * S_q * vis * hd    # scores + pv
        fc.elementwise += 6 * B * H * S_q * vis           # softmax/softcap
    elif kind.startswith("mamba"):
        di, st = cfg.ssm_expand * d, cfg.ssm_state
        fc.matmul += 2 * T * d * 2 * di                   # in proj
        fc.matmul += 2 * T * di * cfg.ssm_conv            # conv
        fc.matmul += 2 * T * di * (2 * st + 1)            # x proj
        fc.matmul += 2 * T * di * d                       # out proj
        fc.elementwise += 8 * T * di * st                 # selective scan
    elif kind == "rwkv":
        fc.matmul += 2 * T * d * d * 6                    # r,k,v,g,decay,out
        fc.elementwise += 6 * T * d * 64                  # wkv state update/read
        fc.matmul += 2 * T * d * f * 2                    # channel mix
        return fc                                         # no separate MLP
    n_mats = 3 if cfg.gated_mlp else 2
    if kind.endswith("_moe"):
        fc.matmul += 2 * T * d * cfg.n_experts            # router
        fc.matmul += 2 * T * cfg.top_k * d * f * n_mats   # routed experts
    elif kind.endswith("_mlp"):
        fc.matmul += 2 * T * d * f * n_mats
    return fc


def cell_flops(cfg: ModelConfig, *, kind: str, seq_len: int,
               global_batch: int) -> FlopCount:
    """kind: 'train' | 'prefill' | 'decode' (one new token, cache=seq_len)."""
    decode = kind == "decode"
    B = global_batch
    S_q = 1 if decode else seq_len
    S_kv = seq_len
    fc = FlopCount()
    for bk in [k for _ in range(cfg.n_superblocks) for k in cfg.block_kinds()]:
        fc = fc + layer_flops(cfg, bk, B, S_q, S_kv, decode=decode)
    if cfg.layer_pattern == "encdec":
        enc_S = 256                                      # stub frame count
        for _ in range(cfg.n_enc_layers):
            fc = fc + layer_flops(cfg, "attn_mlp", B, enc_S, enc_S)
        for _ in range(cfg.n_layers):                    # cross attention
            fc = fc + layer_flops(cfg, "attn", B, S_q, enc_S, decode=decode)
    # unembed + loss
    T = B * S_q
    fc.matmul += 2 * T * cfg.d_model * cfg.vocab
    fc.elementwise += 5 * T * cfg.vocab
    if kind == "train":
        fc = fc.scaled(3.0)                              # fwd + bwd(2x)
    return fc


def model_flops_reference(cfg: ModelConfig, *, kind: str, seq_len: int,
                          global_batch: int) -> float:
    """The standard 6·N·D (train) / 2·N_active·D (inference) reference."""
    n = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n * seq_len * global_batch
    if kind == "prefill":
        return 2.0 * n * seq_len * global_batch
    return 2.0 * n * global_batch                         # decode: D = B tokens


def cell_hbm_bytes(cfg: ModelConfig, *, kind: str, seq_len: int,
                   global_batch: int, optimizer: str = "adamw") -> float:
    """First-order HBM traffic: params once (+grad/opt for train), KV cache
    for decode, activations for train/prefill."""
    bp = {"float32": 4, "bfloat16": 2}[cfg.param_dtype]
    n = cfg.param_count()
    B = global_batch
    if kind == "decode":
        kv = (2 * sum(1 for _ in range(cfg.n_superblocks)
                      for k in cfg.block_kinds() if k.startswith("attn"))
              * cfg.n_kv_heads * cfg.hd * seq_len * B * 2)
        return n * bp + kv
    act = B * seq_len * cfg.d_model * 2 * (cfg.n_layers + 2)
    if kind == "train":
        opt_b = 8.0 if optimizer.startswith("adamw") else 0.1  # factored
        return n * (bp + 4 + opt_b) + act                # + grad f32 + opt
    return n * bp + act
