"""Plain-torch version of the kind-dispatch intersection kernel.

``intersect_dispatch_ref`` consumes the same registry (``dispatch.AND_TABLE``)
as the CUDA kernel: one batched pass per grid cell over exactly the rows
that fall in that cell (rows are selected by index, so a class with no rows
costs nothing and no row computes a cell it is not in). It is what the entry
points in ``ops`` run for CPU tensors, and what the chip smoke holds the
CUDA kernel against.
"""

from __future__ import annotations

import torch

from . import dispatch as D

ROW_WORDS = D.ROW_WORDS

__all__ = ["intersect_dispatch_ref"]

_KERNELS = D.make_and_kernels()


def intersect_dispatch_ref(a_data: torch.Tensor, b_data: torch.Tensor,
                           meta: torch.Tensor):
    """Kind-dispatch intersection over key-aligned raw container rows.

    a_data, b_data: int16[C, 4096] (u16 bit patterns) raw rows — packed
    arrays, bitmap words or run pairs per their kind tag. meta: i32[6C]
    interleaved (kind_a, kind_b, card_a, card_b, nruns_a, nruns_b). Returns
    (hits int16[C, 4096], card i32[C]): per row a 0/1 mask over the array
    side's slots (``mask_*`` cells) or the AND'd bitmap words (``bits``
    cells); pairs with an empty side give zeros.
    """
    ka, kb, ca, cb, ra, rb = D.unpack_meta(meta)
    C = a_data.shape[0]
    hits = torch.zeros((C, ROW_WORDS), dtype=torch.int32, device=a_data.device)
    card = torch.zeros((C,), dtype=torch.int32, device=a_data.device)
    for cls in D.AND_TABLE:
        rows = torch.nonzero(D.class_predicate(cls, ka, kb)).flatten()
        if rows.numel() == 0:
            continue
        x, y, cx, cy, rx, ry = D.bind_args(
            cls, D.widen(a_data[rows]), D.widen(b_data[rows]),
            ca[rows], cb[rows], ra[rows], rb[rows])
        h, c = _KERNELS[cls.kernel](x, y, cx, cy, rx, ry)
        hits[rows] = h
        card[rows] = c
    return D.narrow(hits), card
