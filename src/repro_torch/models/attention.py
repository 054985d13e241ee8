"""GQA attention with dense, sliding-window, blocked (flash) and Roaring
block-sparse modes.

The Roaring path consumes packed block lists produced by
``repro_torch.sparsity.compile_mask``: at train time through
``kernels.sparse_attn.sparse_attention`` (the hand-written CUDA kernel for
CUDA tensors, its plain version for CPU tensors), at decode time through
the Roaring-paged KV cache (``transformer.decode_step_paged``). Single-token
decode against a dense KV cache (``attention_decode``) and the encoder-decoder
``cross_attention`` are plain torch, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed import context as dctx
from repro_torch.kernels.sparse_attn import sparse_attention

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
        pos3 = positions[..., None].expand(*positions.shape, 3)
        q = common.apply_mrope(q, pos3, cfg.rope_theta, cfg.mrope_sections)
        k = common.apply_mrope(k, pos3, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _block_mask(qi, kj, block, row_off, causal, window, device):
    rows = (qi * block + torch.arange(block, device=device))[:, None] \
        + row_off
    cols = (kj * block + torch.arange(block, device=device))[None, :]
    mask = torch.ones((block, block), dtype=torch.bool, device=device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    return mask


def _block_live(qi, kj, block, row_off, causal, window) -> bool:
    """Whether block (qi, kj) holds any unmasked (row, col). A block with
    none contributes nothing to the online softmax (its p is 0, or is wiped
    by the next live block's alpha = 0) nor to the gradients (p = 0), so
    skipping it leaves every result bit for bit as the reference's full
    sweep computes it."""
    r0 = qi * block + row_off
    r1, c0, c1 = r0 + block - 1, kj * block, kj * block + block - 1
    if causal and c0 > r1:
        return False
    return window is None or c1 > r0 - window


def _block_scores(qb, kb, scale, softcap, qi, kj, block, row_off, causal,
                  window):
    """Returns (masked softcapped scores s, raw tanh t for bwd)."""
    s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb) * scale
    t = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
    mask = _block_mask(qi, kj, block, row_off, causal, window, qb.device)
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=qb.device))
    return s, t


def _flash_fwd_impl(q, k, v, scale, softcap, causal, window, block):
    """q: [B,S,KVH,G,hd] f32; k,v: [B,S_kv,KVH,hd] f32 -> (out, lse)."""
    B, S, KVH, G, hd = q.shape
    S_kv = k.shape[1]
    nq, nk = S // block, S_kv // block
    row_off = S_kv - S
    out = torch.empty((B, S, KVH, G, hd), dtype=torch.float32,
                      device=q.device)
    lse = torch.empty((B, S, KVH, G), dtype=torch.float32, device=q.device)
    for qi in range(nq):
        qb = q[:, qi * block:(qi + 1) * block]
        m = torch.full((B, KVH, G, block, 1), NEG_INF, device=q.device)
        l = torch.zeros((B, KVH, G, block, 1), device=q.device)
        o = torch.zeros((B, KVH, G, block, hd), device=q.device)
        for kj in range(nk):
            if not _block_live(qi, kj, block, row_off, causal, window):
                continue
            kb = k[:, kj * block:(kj + 1) * block]
            vb = v[:, kj * block:(kj + 1) * block]
            s, _ = _block_scores(qb, kb, scale, softcap, qi, kj, block,
                                 row_off, causal, window)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            o = o * alpha + torch.einsum("bkgqs,bskd->bkgqd", p, vb)
            m = m_new
        l_safe = torch.clamp(l, min=1e-30)
        # [B, KVH, G, block, hd] -> [B, block, KVH, G, hd]
        out[:, qi * block:(qi + 1) * block] = (o / l_safe).permute(
            0, 3, 1, 2, 4)
        lse[:, qi * block:(qi + 1) * block] = (m + torch.log(l_safe))[
            ..., 0].permute(0, 3, 1, 2)
    return out, lse


class _Flash(torch.autograd.Function):
    """Blocked online-softmax attention with the reference's flash-style
    backward (blockwise recompute; residuals are only (o, lse) per row)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, softcap, causal, window, block):
        out, lse = _flash_fwd_impl(q, k, v, scale, softcap, causal, window,
                                   block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (scale, softcap, causal, window, block)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        scale, softcap, causal, window, block = ctx.opts
        B, S, KVH, G, hd = q.shape
        S_kv = k.shape[1]
        nq, nk = S // block, S_kv // block
        row_off = S_kv - S
        do = do.float()
        # D_i = do_i . o_i (per row), [B, S, KVH, G]
        Dr = (do * out).sum(dim=-1)
        dq = torch.zeros_like(q)
        dk = torch.zeros((B, S_kv, KVH, hd), dtype=torch.float32,
                         device=q.device)
        dv = torch.zeros_like(dk)
        for qi in range(nq):
            rs = slice(qi * block, (qi + 1) * block)
            qb, dob = q[:, rs], do[:, rs]
            # [B, block, KVH, G] -> [B, KVH, G, block]
            lse_t = lse[:, rs].permute(0, 2, 3, 1)
            D_t = Dr[:, rs].permute(0, 2, 3, 1)
            dq_b = torch.zeros((B, block, KVH, G, hd), dtype=torch.float32,
                               device=q.device)
            for kj in range(nk):
                if not _block_live(qi, kj, block, row_off, causal, window):
                    continue
                cs = slice(kj * block, (kj + 1) * block)
                kb, vb = k[:, cs], v[:, cs]
                s, t = _block_scores(qb, kb, scale, softcap, qi, kj, block,
                                     row_off, causal, window)
                p = torch.exp(s - lse_t[..., None])          # [B,KVH,G,bq,bk]
                dp = torch.einsum("bqkgd,bskd->bkgqs", dob, vb)
                dv[:, cs] += torch.einsum("bkgqs,bqkgd->bskd", p, dob)
                ds = p * (dp - D_t[..., None])
                if softcap is not None:
                    ds = ds * (1.0 - t * t)
                ds = ds * scale
                dq_b = dq_b + torch.einsum("bkgqs,bskd->bqkgd", ds, kb)
                dk[:, cs] += torch.einsum("bkgqs,bqkgd->bskd", ds, qb)
            dq[:, rs] = dq_b
        return dq, dk, dv, None, None, None, None, None


def flash_attn(q, k, v, cfg: ModelConfig, *, causal: bool,
               window: Optional[int] = None, block: int = 512):
    """Blocked online-softmax attention (O(S) memory) in plain torch, the
    reference's ``flash_attn_jnp``: f32 math, a flash-style backward with
    blockwise recompute. Blocks wholly masked are skipped (``_block_live``).
    q: [B,S,H,hd]; k,v: [B,S_kv,KVH,hd] -> [B,S,H,hd] in q's dtype."""
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qf = q.reshape(B, S, KVH, G, hd).float()
    out = _Flash.apply(qf, k.float(), v.float(), hd ** -0.5,
                       cfg.attn_softcap, causal, window, block)
    return out.reshape(B, S, H, hd).to(q.dtype)


def _dense_attn(q, k, v, cfg: ModelConfig, *, causal: bool,
                window: Optional[int] = None) -> torch.Tensor:
    """q: [B,S,H,hd]; k,v: [B,S_kv,KVH,hd] -> [B,S,H,hd]."""
    B, S, H, hd = q.shape
    S_kv, KVH = k.shape[1], k.shape[2]
    if S >= 2048 and S_kv >= 2048 and S % 512 == 0 and S_kv % 512 == 0:
        return flash_attn(q, k, v, cfg, causal=causal, window=window)
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
    """Full-sequence attention (training / prefill).

    ``block_lists``: optional (kv_idx, counts) Roaring-extracted block
    lists, tensors on ``x``'s device; when given and ``cfg.attn_impl ==
    'sparse'``, global layers take the block-sparse path."""
    q, k, v = _project_qkv(params, x, cfg, positions)
    local = "local" in layer_kind
    if cfg.attn_impl == "sparse" and block_lists is not None and not local:
        kv_idx, counts = block_lists
        out = sparse_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), kv_idx,
            counts, cfg.sparse_block, cfg.sparse_block, causal,
            cfg.attn_softcap, None)
        out = out.transpose(1, 2)
    else:
        out = _dense_attn(q, k, v, cfg, causal=causal,
                          window=cfg.window if local else None)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))


def attention_decode(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos: torch.Tensor, layer_kind: str = "attn_mlp",
                     write: Optional[torch.Tensor] = None):
    """Single-token decode against a dense KV cache.

    x: [B, 1, d]; cache_k / cache_v: [B, S_max, KVH, hd]; pos: int[B]
    current index. Returns ``(out [B, 1, d], cache_k, cache_v)``; the caches
    are updated **in place** (the reference returns new ones) and returned.
    The write lands at ``pos`` clamped to ``[0, S_max - 1]``, as the
    reference's ``dynamic_update_slice`` clamps it, and the row attends to
    positions ``<= pos``. ``write`` (bool[B]; default every row, the
    reference's behaviour) selects the rows whose K/V is stored; a row left
    out stores nothing and attends to positions ``< pos``, as a row of
    ``transformer.decode_step_paged`` that does not write does.
    """
    B = x.shape[0]
    dev = x.device
    pos = pos.to(dev).long()
    q, k, v = _project_qkv(params, x, cfg, pos[:, None])
    S_max = cache_k.shape[1]
    rows = (torch.arange(B, device=dev) if write is None
            else torch.nonzero(write.to(dev)).flatten())
    at = torch.clamp(pos, 0, S_max - 1)[rows]
    cache_k[rows, at] = k[rows, 0].to(cache_k.dtype)
    cache_v[rows, at] = v[rows, 0].to(cache_v.dtype)
    out = decode_attention(q, cache_k, cache_v, pos, cfg,
                           layer_kind=layer_kind, write=write)
    return (torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype)),
            cache_k, cache_v)


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor,
                     cfg: ModelConfig, *, layer_kind: str = "attn_mlp",
                     write: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dense attention of one decode token (``attention_decode`` after
    its cache write, before the output projection): q [B, 1, H, hd]
    against the whole cache [B, S_max, KVH, hd] in f32, positions past the
    row's last (and, on a local layer, outside its window) masked. Returns
    [B, 1, H, hd] in q's dtype."""
    B, dev = q.shape[0], q.device
    S_max, KVH = cache_k.shape[1], cache_k.shape[2]
    H, hd = q.shape[2], q.shape[3]
    group = H // KVH
    scale = hd ** -0.5
    # sequence-parallel long-context decode keeps the scores sharded along
    # the cache's sequence dim, as the reference pins them
    seq_parallel = S_max >= (1 << 17)
    qg = q.reshape(B, KVH, group, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), cache_k.float()) * scale
    if seq_parallel:
        s = dctx.constrain(s, (None, None, None, "all"))
    if cfg.attn_softcap is not None:
        s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
    last = pos if write is None else pos - (~write.to(dev)).long()
    cols = torch.arange(S_max, device=dev)[None, :]
    live = cols <= last[:, None]
    if "local" in layer_kind:
        live &= cols > (pos[:, None] - cfg.window)
    s = torch.where(live[:, None, None, :], s,
                    torch.tensor(NEG_INF, device=dev))
    p = torch.softmax(s, dim=-1)
    if seq_parallel:
        p = dctx.constrain(p, (None, None, None, "all"))
    out = torch.einsum("bkgs,bskd->bkgd", p, cache_v.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def cross_attention(params: dict, x: torch.Tensor, memory: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Encoder-decoder cross attention (whisper): q from x, k / v from
    memory (in the wider of memory's and x's dtypes, as the reference's
    einsum promotes)."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    mdt = torch.promote_types(memory.dtype, x.dtype)
    k = torch.einsum("bsd,dhk->bshk", memory.to(mdt),
                     params["wk"].to(x.dtype).to(mdt))
    v = torch.einsum("bsd,dhk->bshk", memory.to(mdt),
                     params["wv"].to(x.dtype).to(mdt))
    out = _dense_attn(q, k, v, cfg, causal=False)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
