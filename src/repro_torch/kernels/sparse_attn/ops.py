"""Entry points for Roaring block-sparse attention and paged decode.

A CUDA tensor launches the hand-written kernel (``kernel.
sparse_flash_attention_cuda`` / ``kernel.paged_decode_cuda``, which count
their launches); a CPU tensor runs the plain version (``ref.
sparse_attention_ref`` / ``ref.paged_decode_ref``). The tensor's device
decides, nothing else: there is no switch and no fallback.

``sparse_attention`` is differentiable: its backward recomputes through the
plain version (flash-style recompute: no S x S residuals are saved), as the
reference's ``custom_vjp`` does; the reference has no backward kernel.
"""

from __future__ import annotations

import torch

from . import kernel as _k
from . import ref as _ref


class _SparseAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_idx, counts, block_q, block_kv, causal,
                softcap, scale):
        ctx.save_for_backward(q, k, v, kv_idx, counts)
        ctx.opts = dict(block_q=block_q, block_kv=block_kv, causal=causal,
                        softcap=softcap, scale=scale)
        if q.is_cuda:
            return _k.sparse_flash_attention_cuda(
                q.contiguous(), k.contiguous(), v.contiguous(),
                kv_idx.to(torch.int32).contiguous(),
                counts.to(torch.int32).contiguous(), **ctx.opts)
        return _ref.sparse_attention_ref(q, k, v, kv_idx, counts, **ctx.opts)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_idx, counts = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = _ref.sparse_attention_ref(*qkv, kv_idx, counts, **ctx.opts)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None, None, None, None, None, None


def sparse_attention(q, k, v, kv_idx, counts, block_q=128, block_kv=128,
                     causal=True, softcap=None, scale=None):
    """Block-sparse attention over Roaring-extracted block lists.

    q: [B, H, S, D]; k, v: [B, KVH, S_kv, D] (GQA); kv_idx: int[S /
    block_q, max_active] listed KV block ids per q-block row; counts:
    int[S / block_q] entries in use. Returns [B, H, S, D] in q's dtype.
    """
    return _SparseAttention.apply(q, k, v, kv_idx, counts, block_q,
                                  block_kv, causal, softcap, scale)


def paged_decode(q, k_pages, v_pages, page_idx, counts, lengths, starts=None,
                 softcap=None, scale=None):
    """Decode attention for one new token per sequence (inference only).

    q: [B, KVH, G, D]; k_pages / v_pages: [P, page_size, KVH, D];
    page_idx: int[B, max_pages] physical page ids per sequence, packed from
    the Roaring page table; counts: int[B] pages in use; lengths: int[B]
    positions in the cache; starts: int[B] first visible position
    (sliding-window layers; default 0). Returns [B, KVH, G, D] in q's dtype.
    """
    if starts is None:
        starts = torch.zeros((q.shape[0],), dtype=torch.int32,
                             device=q.device)
    if q.is_cuda:
        def i32(t):
            return t.to(torch.int32).contiguous()
        return _k.paged_decode_cuda(
            q.contiguous(), k_pages.contiguous(), v_pages.contiguous(),
            i32(page_idx), i32(counts), i32(lengths), i32(starts),
            softcap=softcap, scale=scale)
    return _ref.paged_decode_ref(q, k_pages, v_pages, page_idx, counts,
                                 lengths, starts, softcap=softcap, scale=scale)
