"""GQA attention: projections and the dense (sliding-window) mode used by
the teacher-forced ``forward``.

Decode against the Roaring-paged KV cache goes through
``repro_torch.kernels.sparse_attn.paged_decode`` (``transformer.
decode_step_paged``). Two branches of the reference wait for later slices
and raise ``NotImplementedError``: the blocked online-softmax attention it
takes for long sequences, and the Roaring block-sparse training path.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import common
from .common import NEG_INF
from .config import ModelConfig


def attn_init(cfg: ModelConfig, dtype, *, generator, stack=None) -> dict:
    d, hd, H, KVH = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads

    def w(shape):
        return common.dense_init(shape, dtype, generator=generator,
                                 stack=stack)
    return {"wq": w((d, H, hd)), "wk": w((d, KVH, hd)),
            "wv": w((d, KVH, hd)), "wo": w((H, hd, d))}


def _project_qkv(params, x, cfg: ModelConfig, positions):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(x.dtype))
    if cfg.mrope_sections is not None:
        raise NotImplementedError("M-RoPE (qwen2-vl) is not ported yet; see "
                                  "ROADMAP.md queue 1")
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _dense_attn(q, k, v, cfg: ModelConfig, *, causal: bool,
                window: Optional[int] = None) -> torch.Tensor:
    """q: [B,S,H,hd]; k,v: [B,S_kv,KVH,hd] -> [B,S,H,hd]."""
    B, S, H, hd = q.shape
    S_kv, KVH = k.shape[1], k.shape[2]
    if S >= 2048 and S_kv >= 2048 and S % 512 == 0 and S_kv % 512 == 0:
        raise NotImplementedError(
            "the reference takes its blocked online-softmax attention "
            "(flash_attn_jnp) for S >= 2048 divisible by 512; that branch "
            "is not ported yet, see ROADMAP.md queue 1")
    group = H // KVH
    scale = hd ** -0.5
    qg = q.reshape(B, S, KVH, group, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if cfg.attn_softcap is not None:
        s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
    dev = q.device
    rows = torch.arange(S, device=dev)[:, None] + (S_kv - S)   # align ends
    cols = torch.arange(S_kv, device=dev)[None, :]
    mask = torch.ones((S, S_kv), dtype=torch.bool, device=dev)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=dev))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def attention(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, layer_kind: str = "attn_mlp",
              block_lists=None, causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (teacher-forced forward / prefill)."""
    local = "local" in layer_kind
    if cfg.attn_impl == "sparse" and block_lists is not None and not local:
        raise NotImplementedError(
            "Roaring block-sparse attention (sparse_flash_attention) comes "
            "with the training slice; see ROADMAP.md queue 2")
    q, k, v = _project_qkv(params, x, cfg, positions)
    out = _dense_attn(q, k, v, cfg, causal=causal,
                      window=cfg.window if local else None)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
