"""Plain PyTorch versions of the attention kernels.

They are what the entry points run for CPU tensors, and what
``chip_smoke.py`` and the card's tests hold the CUDA kernels against.

* ``sparse_attention_ref``: dense masked attention in f32, the reference's
  oracle for the block-sparse flash kernel. A row with no live score gives
  zeros, as the oracle does. K and V are zeroed in the KV blocks that no
  q-block row lists, so a NaN there cannot reach an output or a gradient
  through ``0 * NaN`` (the reference's oracle lets it through).
* ``paged_decode_ref``: the reference's ``paged_decode_ref`` with two edges
  made explicit: a position is live only inside the first ``counts[b]``
  pages (the reference's version also reads the pages after them, and a
  NaN there reaches its output through ``0 * NaN``), and a row with no live
  position gives zeros (the reference's version averages V there).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def block_mask_to_dense(kv_idx: torch.Tensor, counts: torch.Tensor,
                        num_kv_blocks: int) -> torch.Tensor:
    """[num_qb, max_active] packed block lists -> bool[num_qb,
    num_kv_blocks]. Entries at or after ``counts`` and ids outside
    ``[0, num_kv_blocks)`` list nothing."""
    num_qb, max_active = kv_idx.shape
    dev = kv_idx.device
    ids = kv_idx.long()
    valid = ((torch.arange(max_active, device=dev)[None, :]
              < counts.to(dev)[:, None]) & (ids >= 0) & (ids < num_kv_blocks))
    rows = torch.arange(num_qb, device=dev)[:, None].expand(num_qb,
                                                            max_active)
    dense = torch.zeros((num_qb, num_kv_blocks), dtype=torch.bool, device=dev)
    dense[rows[valid], ids[valid]] = True
    return dense


def sparse_attention_ref(q, k, v, kv_idx, counts, *, block_q=128,
                         block_kv=128, causal=True, softcap=None, scale=None):
    """Dense masked attention: q [B, H, S, D]; k, v [B, KVH, S_kv, D] (GQA:
    query head h reads KV head h // (H // KVH)); kv_idx int[S / block_q,
    max_active], counts int[S / block_q]. Returns [B, H, S, D] in q's
    dtype. Differentiable in q, k and v."""
    B, H, S, D = q.shape
    KVH, S_kv = k.shape[1], k.shape[2]
    G = H // KVH
    if scale is None:
        scale = D ** -0.5
    dev = q.device
    blockmask = block_mask_to_dense(kv_idx.to(dev), counts.to(dev),
                                    S_kv // block_kv)
    elem = blockmask.repeat_interleave(block_q, 0).repeat_interleave(
        block_kv, 1)                                          # [S, S_kv]
    if causal:
        elem = elem & (torch.arange(S_kv, device=dev)[None, :]
                       <= torch.arange(S, device=dev)[:, None])
    listed = blockmask.any(0).repeat_interleave(block_kv)[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    kf = torch.where(listed, k.float(), zero)
    vf = torch.where(listed, v.float(), zero)
    qg = q.float().reshape(B, KVH, G, S, D)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, kf) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(elem, s, torch.tensor(NEG_INF, device=dev))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, vf)
    out = torch.where(elem.any(-1)[:, None], out, zero)
    return out.reshape(B, H, S, D).to(q.dtype)


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
