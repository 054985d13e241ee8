"""Plain-torch versions of the Roaring container kernels.

``container_op_ref`` (word op + popcount) and ``array_intersect_ref``
(packed-array lower-bound intersection) follow the reference package's XLA
oracles. ``intersect_dispatch_ref`` consumes the same registry
(``dispatch.AND_TABLE``) as the CUDA kernel: one batched pass per grid cell
over exactly the rows that fall in that cell (rows are selected by index,
so a class with no rows costs nothing and no row computes a cell it is not
in). They are what the
entry points in ``ops`` run for CPU tensors, and what the chip smoke holds
the CUDA kernels against.
"""

from __future__ import annotations

import torch

from . import dispatch as D

ROW_WORDS = D.ROW_WORDS

__all__ = ["intersect_dispatch_ref", "container_op_ref",
           "array_intersect_ref"]

_KERNELS = D.make_and_kernels()

_OPS = {
    "and": torch.bitwise_and,
    "or": torch.bitwise_or,
    "xor": torch.bitwise_xor,
    "andnot": lambda a, b: torch.bitwise_and(a, ~b),
}


def container_op_ref(a_bits: torch.Tensor, b_bits: torch.Tensor,
                     kinds: torch.Tensor, op: str):
    """Word op + popcount over key-aligned bitmap-domain rows.

    a_bits, b_bits: int16[C, 4096]; kinds: i32[2C] interleaved (kind_a,
    kind_b). Returns (out int16[C, 4096], card i32[C]); a pair whose two
    kinds are both EMPTY gives zeros and card 0 whatever its payload.
    """
    if op not in _OPS:
        raise ValueError(f"unknown container op {op!r} (want one of "
                         f"{sorted(_OPS)})")
    res = _OPS[op](a_bits, b_bits)
    live = (kinds[0::2] != D.KIND_EMPTY) | (kinds[1::2] != D.KIND_EMPTY)
    res = res * live[:, None].to(res.dtype)
    return res, D._row_popcount(D.widen(res))


def array_intersect_ref(a_arr: torch.Tensor, b_arr: torch.Tensor,
                        cards: torch.Tensor):
    """Packed-array intersection by ``searchsorted`` on widened values.

    a_arr, b_arr: int16[C, 4096] packed sorted arrays (u16 bit patterns,
    0xFFFF padded); cards: i32[2C] interleaved (card_a, card_b). Each of
    A's first card_a slots takes the lower bound of its value among B's
    first card_b values. Returns (hits int16[C, 4096] 0/1 over A's slots,
    count i32[C]).
    """
    card_a = cards[0::2].clamp(0, ROW_WORDS)[:, None]
    card_b = cards[1::2].clamp(0, ROW_WORDS)[:, None]
    slot = torch.arange(ROW_WORDS, device=a_arr.device)[None, :]
    a = D.widen(a_arr)
    # B past card_b sorts after every u16 value, so the search window is
    # exactly B's first card_b values
    b = torch.where(slot < card_b, D.widen(b_arr), 1 << 16)
    pos = torch.searchsorted(b, a)
    found = ((torch.gather(b, 1, pos.clamp(max=ROW_WORDS - 1)) == a)
             & (pos < card_b) & (slot < card_a))
    return found.to(torch.int16), found.sum(1, dtype=torch.int32)


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
