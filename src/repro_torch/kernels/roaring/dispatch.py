"""The kind-dispatch registry and its plain-torch row kernels.

One declarative table, ``AND_TABLE``, names for every live
``(kind_a, kind_b)`` container pair the row kernel that intersects it, the
output semantic the slab layer applies, and whether the kernel sees the
operands swapped. The plain-torch reference (``ref.intersect_dispatch_ref``)
and the CUDA kernel (``csrc/intersect_dispatch.cu``, whose cell switch is
generated from this table at build time) both consume it.

Row kernels here are batched over ``M`` rows: ``fn(x, y, cx, cy, rx, ry)``
with ``x``/``y`` i32[M, 4096] (u16 values widened to int32) and the per-row
cardinalities / run counts i32[M], returning ``(hits i32[M, 4096],
card i32[M])``. ``swap`` in a table row means the kernel receives
``(b, a)``.

Output semantics (``PairClass.out``):
  * ``'bits'``   — ``hits`` is a bitmap-domain row (word-op result);
  * ``'mask_a'`` — ``hits`` is a 0/1 mask over ``a``'s packed array slots;
  * ``'mask_b'`` — same, over ``b``'s slots.

``run x run`` is routed by the slab layer to the run-merge form
(``slab_route == 'run_merge'``); the in-kernel ``run_cov_and`` (coverage AND
with a fused popcount) is what the kernel computes for that class.

Payloads are stored as int16 tensors holding the u16 bit patterns (torch's
uint16 lacks shifts, ``~`` and scatter on the CPU); ``widen`` and ``narrow``
convert between that storage and int32 compute values.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

ROW_WORDS = 4096
MAX_RUNS = ROW_WORDS // 2      # (start, length-1) u16 pairs per row

KIND_EMPTY = 0
KIND_ARRAY = 1
KIND_BITMAP = 2
KIND_RUN = 3

__all__ = [
    "ROW_WORDS", "MAX_RUNS",
    "KIND_EMPTY", "KIND_ARRAY", "KIND_BITMAP", "KIND_RUN",
    "PairClass", "AND_TABLE", "class_predicate", "out_mask", "route_mask",
    "union_route", "andnot_route",
    "coverage_by_scatter", "array_coverage_by_scatter", "make_and_kernels",
    "make_lift_kernels",
    "bind_args", "META_FIELDS", "unpack_meta",
    "widen", "narrow", "popcount16",
]


@dataclasses.dataclass(frozen=True)
class PairClass:
    """One cell of the dispatch grid."""

    name: str
    kind_a: int
    kind_b: int
    kernel: str                # row-kernel id in make_and_kernels()
    out: str                   # 'bits' | 'mask_a' | 'mask_b'
    swap: bool = False         # kernel receives (b, a) instead of (a, b)
    slab_route: str = ""       # non-default slab-layer routing ('run_merge')


AND_TABLE: Tuple[PairClass, ...] = (
    PairClass("array_array", KIND_ARRAY, KIND_ARRAY, "gallop", "mask_a"),
    PairClass("array_bitmap", KIND_ARRAY, KIND_BITMAP, "probe", "mask_a"),
    PairClass("bitmap_array", KIND_BITMAP, KIND_ARRAY, "probe", "mask_b",
              swap=True),
    PairClass("bitmap_bitmap", KIND_BITMAP, KIND_BITMAP, "word_and", "bits"),
    PairClass("run_run", KIND_RUN, KIND_RUN, "run_cov_and", "bits",
              slab_route="run_merge"),
    PairClass("array_run", KIND_ARRAY, KIND_RUN, "run_gallop", "mask_a"),
    PairClass("run_array", KIND_RUN, KIND_ARRAY, "run_gallop", "mask_b",
              swap=True),
    PairClass("run_bitmap", KIND_RUN, KIND_BITMAP, "run_mask", "bits"),
    PairClass("bitmap_run", KIND_BITMAP, KIND_RUN, "run_mask", "bits",
              swap=True),
)


def class_predicate(cls: PairClass, ka: torch.Tensor,
                    kb: torch.Tensor) -> torch.Tensor:
    """Row-selection predicate for one grid cell (batched)."""
    return (ka == cls.kind_a) & (kb == cls.kind_b)


def out_mask(out: str, ka: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """Rows whose AND output has the given semantic, honoring the
    slab-layer override for run x run."""
    acc = torch.zeros_like(ka, dtype=torch.bool)
    for cls in AND_TABLE:
        if cls.out == out and not cls.slab_route:
            acc = acc | class_predicate(cls, ka, kb)
    return acc


def route_mask(route: str, ka: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """Rows the slab layer routes specially."""
    acc = torch.zeros_like(ka, dtype=torch.bool)
    for cls in AND_TABLE:
        if cls.slab_route == route:
            acc = acc | class_predicate(cls, ka, kb)
    return acc


def union_route(ka, kb, ca, cb, array_max: int):
    """OR/XOR routing policy: packed sorted-merge only for array-ish pairs
    whose merged size provably stays under the threshold; every other live
    pair goes through the bitmap domain."""
    arrayish = ((ka != KIND_BITMAP) & (ka != KIND_RUN)
                & (kb != KIND_BITMAP) & (kb != KIND_RUN))
    small = arrayish & (ca + cb <= array_max)
    live = (ka != KIND_EMPTY) | (kb != KIND_EMPTY)
    return small, live & ~small


def andnot_route(ka, kb):
    """ANDNOT routing: array-A rows probe B in place (any B kind); bitmap-
    or run-A rows go bitmap domain."""
    probe = ka == KIND_ARRAY
    lift = (ka == KIND_BITMAP) | (ka == KIND_RUN)
    return probe, lift


# =============================================================================
# u16 storage helpers
# =============================================================================

def widen(x: torch.Tensor) -> torch.Tensor:
    """int16 (u16 bit patterns) storage -> int32 values in [0, 65535]."""
    return x.to(torch.int32) & 0xFFFF


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int32 values in [0, 65535] -> int16 storage of the same u16 bits."""
    return torch.where(x >= 0x8000, x - 0x10000, x).to(torch.int16)


def popcount16(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 values in [0, 65535] (SWAR; torch has
    no popcount op)."""
    x = x - ((x >> 1) & 0x5555)
    x = (x & 0x3333) + ((x >> 2) & 0x3333)
    x = (x + (x >> 4)) & 0x0F0F
    return (x + (x >> 8)) & 0x1F


def _row_popcount(bits: torch.Tensor) -> torch.Tensor:
    return popcount16(bits).sum(dim=-1, dtype=torch.int32)


# =============================================================================
# searches and lifts (batched over rows)
# =============================================================================

def _slots(like: torch.Tensor) -> torch.Tensor:
    return torch.arange(ROW_WORDS, dtype=torch.int32, device=like.device)


def _run_upper_bound(run_row, n_runs, p):
    """# run starts <= p over each row's first ``n_runs`` (start, len-1)
    pairs: 12 halvings resolve a window of up to 2048 runs."""
    lo = torch.zeros_like(p)
    hi = n_runs[:, None].expand_as(p).to(torch.int32)
    for _ in range(12):
        open_ = lo < hi                      # empty windows must not probe
        mid = (lo + hi) // 2
        s = torch.gather(run_row, 1, (2 * mid).clamp(0, ROW_WORDS - 2).long())
        go_right = open_ & (s <= p)
        lo, hi = (torch.where(go_right, mid + 1, lo),
                  torch.where(open_ & ~go_right, mid, hi))
    return lo


def _run_covered(run_row, n_runs, p):
    """Is each ``p`` inside one of its row's runs (binary search of the run
    list)."""
    idx = _run_upper_bound(run_row, n_runs, p) - 1
    idx_c = idx.clamp(0, MAX_RUNS - 1).long()
    s = torch.gather(run_row, 1, 2 * idx_c)
    ln = torch.gather(run_row, 1, 2 * idx_c + 1)
    return (idx >= 0) & (p <= s + ln)


def coverage_by_scatter(run_row: torch.Tensor, n_runs=None) -> torch.Tensor:
    """Run rows i32[M, 4096] -> coverage bitmap rows via a difference-array
    scatter, O(n_runs + 4096) per row. Every valid pair counts; the
    ``(0xFFFF, 0xFFFF)`` padding fails ``start + len-1 < 2^16``."""
    M = run_row.shape[0]
    pairs = run_row.reshape(M, MAX_RUNS, 2)
    s, ln = pairs[..., 0], pairs[..., 1]
    valid = (s + ln) < (1 << 16)
    e = s + ln
    fw, lw = s >> 4, e >> 4
    mask_a = (0xFFFF << (s & 15)) & 0xFFFF
    mask_b = 0xFFFF >> (15 - (e & 15))
    same = fw == lw
    m_first = torch.where(same, mask_a & mask_b, mask_a)
    partial = torch.zeros((M, ROW_WORDS + 1), dtype=torch.int32,
                          device=run_row.device)
    drop = torch.full_like(fw, ROW_WORDS)
    partial.scatter_add_(1, torch.where(valid, fw, drop).long(), m_first)
    partial.scatter_add_(1, torch.where(valid & ~same, lw, drop).long(),
                         mask_b)
    span = valid & (lw > fw)
    diff = torch.zeros((M, ROW_WORDS + 2), dtype=torch.int32,
                       device=run_row.device)
    drop2 = torch.full_like(fw, ROW_WORDS + 1)
    diff.scatter_add_(1, torch.where(span, fw + 1, drop2).long(),
                      torch.ones_like(fw))
    diff.scatter_add_(1, torch.where(span, lw, drop2).long(),
                      -torch.ones_like(fw))
    full = (torch.cumsum(diff, 1)[:, :ROW_WORDS] > 0).to(torch.int32) * 0xFFFF
    return (partial[:, :ROW_WORDS] | full) & 0xFFFF


def array_coverage_by_scatter(arr_row: torch.Tensor,
                              card: torch.Tensor) -> torch.Tensor:
    """Packed sorted array rows -> membership bitmap rows via one-hot word
    scatter, O(4096) per row (values are distinct, so add == or)."""
    M = arr_row.shape[0]
    valid = _slots(arr_row)[None, :] < card[:, None]
    words = torch.zeros((M, ROW_WORDS + 1), dtype=torch.int32,
                        device=arr_row.device)
    idx = torch.where(valid, arr_row >> 4, ROW_WORDS).long()
    words.scatter_add_(1, idx, (1 << (arr_row & 15)).to(torch.int32))
    return words[:, :ROW_WORDS]


def make_lift_kernels() -> Dict[int, Callable]:
    """Kind -> bitmap-domain lift table: ``fn(rows, card, n_runs) -> bits
    i32[M, 4096]``, the rows' membership bitmaps whatever their stored
    kind."""
    return {
        KIND_EMPTY: lambda row, c, r: torch.zeros_like(row),
        KIND_ARRAY: lambda row, c, r: array_coverage_by_scatter(row, c),
        KIND_BITMAP: lambda row, c, r: row,
        KIND_RUN: lambda row, c, r: coverage_by_scatter(row, r),
    }


def make_and_kernels() -> Dict[str, Callable]:
    """The AND row kernels, batched, with the scatter-form run lift."""

    def k_gallop(x, y, cx, cy, rx, ry):
        # every slot of x lower-bounds y's packed sorted prefix: 13 halvings
        # resolve a window of up to 4096
        lo = torch.zeros_like(x)
        hi = cy[:, None].expand_as(x).to(torch.int32)
        for _ in range(13):
            mid = (lo + hi) // 2
            vals = torch.gather(y, 1, mid.clamp(0, ROW_WORDS - 1).long())
            go_right = vals < x
            lo, hi = (torch.where(go_right, mid + 1, lo),
                      torch.where(go_right, hi, mid))
        found = torch.gather(y, 1, lo.clamp(0, ROW_WORDS - 1).long()) == x
        found = (found & (lo < cy[:, None])
                 & (_slots(x)[None, :] < cx[:, None]))
        return found.to(torch.int32), found.sum(1, dtype=torch.int32)

    def k_probe(x, y, cx, cy, rx, ry):
        # x's packed values index y's bitmap words directly
        word = torch.gather(y, 1, (x >> 4).long())
        hit = (((word >> (x & 15)) & 1) == 1) & (
            _slots(x)[None, :] < cx[:, None])
        return hit.to(torch.int32), hit.sum(1, dtype=torch.int32)

    def k_word_and(x, y, cx, cy, rx, ry):
        res = x & y
        return res, _row_popcount(res)

    def k_run_gallop(x, y, cx, cy, rx, ry):
        hit = _run_covered(y, ry, x) & (_slots(x)[None, :] < cx[:, None])
        return hit.to(torch.int32), hit.sum(1, dtype=torch.int32)

    def k_run_mask(x, y, cx, cy, rx, ry):
        res = coverage_by_scatter(x, rx) & y
        return res, _row_popcount(res)

    def k_run_cov_and(x, y, cx, cy, rx, ry):
        res = coverage_by_scatter(x, rx) & coverage_by_scatter(y, ry)
        return res, _row_popcount(res)

    return {
        "gallop": k_gallop,
        "probe": k_probe,
        "word_and": k_word_and,
        "run_gallop": k_run_gallop,
        "run_mask": k_run_mask,
        "run_cov_and": k_run_cov_and,
    }


def bind_args(cls: PairClass, da, db, ca, cb, ra, rb):
    """Operand roles for one grid cell (apply ``swap``)."""
    if cls.swap:
        return db, da, cb, ca, rb, ra
    return da, db, ca, cb, ra, rb


META_FIELDS = 6  # (kind_a, kind_b, card_a, card_b, nruns_a, nruns_b)


def unpack_meta(meta: torch.Tensor, i=None):
    """Interleaved i32[6C] meta -> per-row fields (scalars at ``i`` or
    batched slices)."""
    if i is None:
        return tuple(meta[j::META_FIELDS] for j in range(META_FIELDS))
    return tuple(meta[META_FIELDS * i + j] for j in range(META_FIELDS))
