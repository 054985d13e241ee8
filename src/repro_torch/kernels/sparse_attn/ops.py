"""Entry point for paged decode attention.

A CUDA tensor launches the hand-written kernel (``kernel.
paged_decode_cuda``, which counts the launch); a CPU tensor runs the plain
version (``ref.paged_decode_ref``). The tensor's device decides, nothing
else: there is no switch and no fallback.
"""

from __future__ import annotations

import torch

from . import kernel as _k
from . import ref as _ref


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
