"""Plain PyTorch version of the paged decode kernel.

It is what the entry point runs for CPU tensors, and what ``chip_smoke.py``
and the card's tests hold the CUDA kernel against. It computes the kernel's
function, which is the reference's ``paged_decode_ref`` with two edges made
explicit: a position is live only inside the first ``counts[b]`` pages (the
reference's version also reads the pages after them, and a NaN there
reaches its output through ``0 * NaN``), and a row with no live position
gives zeros (the reference's version averages V there).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_decode_ref(q, k_pages, v_pages, page_idx, counts, lengths,
                     starts=None, *, softcap=None, scale=None):
    """Gather-then-attend: q [B, KVH, G, D]; pools [P, page_size, KVH, D];
    page_idx int[B, max_pages]; counts / lengths / starts int[B]."""
    B, KVH, G, D = q.shape
    P, page_size = k_pages.shape[0], k_pages.shape[1]
    max_pages = page_idx.shape[1]
    if scale is None:
        scale = D ** -0.5
    dev = q.device
    if starts is None:
        starts = torch.zeros((B,), dtype=torch.int32, device=dev)
    page_idx = page_idx.long()
    page_ok = (page_idx >= 0) & (page_idx < P)
    pages = page_idx.clamp(0, P - 1)
    # logical KV streams: [B, max_pages * page_size, KVH, D]
    k_seq = k_pages[pages].reshape(B, max_pages * page_size, KVH, D)
    v_seq = v_pages[pages].reshape(B, max_pages * page_size, KVH, D)
    pos = torch.arange(max_pages * page_size, device=dev)
    live = ((pos[None, :] < lengths[:, None]) & (pos[None, :] >= starts[:, None])
            & (pos[None, :] < counts[:, None] * page_size)
            & page_ok.repeat_interleave(page_size, dim=1))        # [B, L]
    s = torch.einsum("bkgd,blkd->bkgl", q.float(), k_seq.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(live[:, None, None, :], s, torch.tensor(NEG_INF,
                                                              device=dev))
    p = torch.softmax(s, dim=-1)
    v_live = torch.where(live[:, :, None, None], v_seq.float(),
                         torch.zeros((), device=dev))
    out = torch.einsum("bkgl,blkd->bkgd", p, v_live)
    out = torch.where(live.any(dim=1)[:, None, None, None], out,
                      torch.zeros((), device=dev))
    return out.to(q.dtype)
