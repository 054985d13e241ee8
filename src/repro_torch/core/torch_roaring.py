"""The static-shape Roaring container slab in PyTorch.

A ``RoaringSlab`` holds up to ``C`` containers. Row ``i`` of ``data``
(u16[4096] = 8 kB, stored as int16 bit patterns) is a packed sorted array
(first ``card[i]`` entries, 0xFFFF padded), a 2^16-bit bitmap as 4096 words,
or a packed run list of sorted ``(start, length-1)`` pairs padded with
``(0xFFFF, 0xFFFF)``. ``keys`` is the sorted first-level index (padded with
``KEY_SENTINEL``), ``card`` the per-container cardinalities, ``kind`` the
container type tag (0 empty / 1 array / 2 bitmap / 3 run).

This module holds the row-state algebra the query engine runs on: the AND
combine goes through the kind-dispatch kernel (``ops.intersect_dispatch``:
CUDA on the card, its plain version on the CPU); OR, ANDNOT and the
best-of-three canonicalization (``_finalize``) are plain torch. On top of
it sit the constructors (``from_indices``, ``from_dense_array``,
``from_ranges``), the access operations (``contains``, ``rank``,
``slab_select``, ``extract_row``) and the pairwise and N-way set algebra
(``slab_and`` / ``slab_or`` / ``slab_xor`` / ``slab_andnot``, their
cardinality-only forms, ``union_many_slabs``) that the object API wraps.
Where the reference guards an expensive pass with ``lax.cond``, this
module computes it over just the rows that need it (selected with
``torch.nonzero``); each such selection is one host sync — a ``_finalize``
costs at most six, an ``_or_rows`` / ``_andnot_rows`` step two to four —
and sits in a ``device.wait`` span of ``repro_torch.obs``.
Rows no pass touches get the same fill values as in the reference, so
results are byte-identical.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.kernels.roaring import dispatch as _D
from repro_torch.kernels.roaring.dispatch import _row_popcount, narrow, widen

CHUNK_BITS = 16
CHUNK_SIZE = 1 << CHUNK_BITS
ARRAY_MAX = 4096                 # paper's array/bitmap threshold
ROW_WORDS = 4096                 # 4096 x u16 words = 2^16 bits = 8 kB
MAX_RUNS = ROW_WORDS // 2        # (start, length-1) pairs per run row
KEY_SENTINEL = 1 << 20

KIND_EMPTY = _D.KIND_EMPTY
KIND_ARRAY = _D.KIND_ARRAY
KIND_BITMAP = _D.KIND_BITMAP
KIND_RUN = _D.KIND_RUN

# raw row forms flowing into the canonicalization engine
FORM_ARRAY, FORM_BITS, FORM_RUNS = 0, 1, 2

__all__ = [
    "CHUNK_BITS", "CHUNK_SIZE", "ARRAY_MAX", "ROW_WORDS", "MAX_RUNS",
    "KEY_SENTINEL", "KIND_EMPTY", "KIND_ARRAY", "KIND_BITMAP", "KIND_RUN",
    "RoaringSlab", "empty", "from_indices", "from_dense_array",
    "from_ranges", "from_roaring", "to_roaring", "to_indices",
    "extract_row", "contains", "rank", "slab_select", "slab_run_optimize",
    "slab_and", "slab_and_card", "slab_or_card", "slab_jaccard",
    "slab_and_many", "slab_and_card_many", "slab_or", "slab_xor",
    "slab_andnot", "slab_and_bitmap_domain", "slab_or_bitmap_domain",
    "union_many_slabs", "row_bits_to_array", "row_nruns_bits",
]


class RoaringSlab(NamedTuple):
    """Internal row-state slab: ``C = keys.shape[0]`` containers."""

    keys: torch.Tensor   # i32[C], sorted, inactive rows = KEY_SENTINEL
    card: torch.Tensor   # i32[C]
    kind: torch.Tensor   # i32[C]
    data: torch.Tensor   # int16[C, 4096] (u16 bit patterns)


# =============================================================================
# helpers
# =============================================================================

def _slots(device) -> torch.Tensor:
    return torch.arange(ROW_WORDS, dtype=torch.int32, device=device)


def _rows_where(mask: torch.Tensor) -> torch.Tensor:
    """Indices of the true rows (one host sync, in a ``device.wait``
    span)."""
    with obs.span("device.wait"):
        return torch.nonzero(mask).flatten()


def _fill(shape, value: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full(shape, value, dtype=torch.int32, device=like.device)


def _pick_kind(card: torch.Tensor, nruns: torch.Tensor) -> torch.Tensor:
    """Strict best-of-three serialized-size rule (must match the oracle's
    ``py_roaring._canonical``): run iff 4*n_runs is strictly smaller than
    every alternative; array preferred at the 4096 tie."""
    other = torch.where(card <= ARRAY_MAX,
                        torch.clamp(2 * card, max=2 * ARRAY_MAX),
                        torch.full_like(card, 2 * ARRAY_MAX))
    run_best = (4 * nruns < other) & (card > 0)
    kind = torch.where(card <= ARRAY_MAX, KIND_ARRAY, KIND_BITMAP)
    kind = torch.where(run_best, KIND_RUN, kind)
    return torch.where(card == 0, KIND_EMPTY, kind).to(torch.int32)


def _rows_nruns(data: torch.Tensor, kind: torch.Tensor) -> torch.Tensor:
    """Per-row run counts of run rows (0 for other kinds)."""
    out = torch.zeros(kind.shape, dtype=torch.int32, device=kind.device)
    flat_kind = kind.reshape(-1)
    rows = _rows_where(flat_kind == KIND_RUN)
    if rows.numel():
        p = widen(data.reshape(-1, ROW_WORDS)[rows]).reshape(-1, MAX_RUNS, 2)
        valid = (p[..., 0] + p[..., 1]) < CHUNK_SIZE
        out.reshape(-1)[rows] = valid.sum(-1, dtype=torch.int32)
    return out


def _dispatch_meta(ka, kb, ca, cb, ra, rb) -> torch.Tensor:
    """Interleave (kind_a, kind_b, card_a, card_b, nruns_a, nruns_b) per row
    -> i32[6C] (the dispatch kernel's meta contract)."""
    return torch.stack([ka, kb, ca, cb, ra, rb], dim=1).reshape(-1).to(
        torch.int32)


def _pad_keys(keys: torch.Tensor, capacity: int) -> torch.Tensor:
    n = keys.shape[0]
    if capacity <= n:
        return keys[:capacity]
    return torch.cat([keys, torch.full((capacity - n,), KEY_SENTINEL,
                                       dtype=torch.int32, device=keys.device)])


def _merge_keys_many(key_cols, capacity: int) -> torch.Tensor:
    """Union of N sorted key columns, deduplicated (duplicates demoted to
    ``KEY_SENTINEL`` and re-sorted), padded/truncated to ``capacity``."""
    srt = torch.sort(torch.cat(key_cols)).values
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=srt.device),
                     srt[1:] == srt[:-1]])
    return _pad_keys(torch.sort(torch.where(dup, KEY_SENTINEL, srt)).values
                     .to(torch.int32), capacity)


def _gather_raw(s: RoaringSlab, keys: torch.Tensor):
    """Raw rows of ``s`` aligned to ``keys`` — native container form.
    Absent keys get (card=0, kind=EMPTY)."""
    C = s.keys.shape[0]
    pos = torch.searchsorted(s.keys.contiguous(), keys.contiguous())
    pos_c = torch.clamp(pos, max=C - 1)
    present = (s.keys[pos_c] == keys) & (keys != KEY_SENTINEL)
    data = s.data[pos_c]
    card = torch.where(present, s.card[pos_c], 0).to(torch.int32)
    kind = torch.where(present, s.kind[pos_c], KIND_EMPTY).to(torch.int32)
    return data, card, kind


def _compact_rows(vals: torch.Tensor, hit: torch.Tensor) -> torch.Tensor:
    """Scatter each row's hit subset into a fresh packed sorted row (0xFFFF
    padded). vals i32[M, 4096], hit bool[M, 4096] -> int16[M, 4096]."""
    h = hit.to(torch.int32)
    rank = torch.cumsum(h, 1) - h
    idx = torch.where(hit, rank, ROW_WORDS).long()
    out = _fill((vals.shape[0], ROW_WORDS + 1), 0xFFFF, vals)
    out.scatter_(1, idx, vals)
    return narrow(out[:, :ROW_WORDS])


# =============================================================================
# row conversions (batched; int32 values in, int32 values out)
# =============================================================================

def row_bits_to_array(bits: torch.Tensor) -> torch.Tensor:
    """Vectorized Algorithm 2 over rows: bitmap rows i32[M, 4096] -> the
    first 4096 set-bit positions of each row, packed (zeros past them)."""
    M = bits.shape[0]
    shifts = torch.arange(16, dtype=torch.int32, device=bits.device)
    bitmat = ((bits[:, :, None] >> shifts) & 1).reshape(M, CHUNK_SIZE) == 1
    with obs.span("device.wait"):
        r, pos = torch.nonzero(bitmat, as_tuple=True)
    counts = bitmat.sum(1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(r.numel(), device=bits.device) - starts[r]
    keep = rank < ROW_WORDS
    out = torch.zeros((M, ROW_WORDS), dtype=torch.int32, device=bits.device)
    with obs.span("device.wait"):     # three boolean-mask selections
        out[r[keep], rank[keep]] = pos[keep].to(torch.int32)
    return out


def _row_edges(bits: torch.Tensor):
    """(rising, falling') edge bitmaps of bitmap rows: rising marks run
    starts, falling' the position after each run end. Word-carry chained."""
    prev = torch.cat([torch.zeros_like(bits[:, :1]), bits[:, :-1]], 1)
    shifted = ((bits << 1) | (prev >> 15)) & 0xFFFF
    rising = bits & ~shifted & 0xFFFF
    falling = ~bits & shifted & 0xFFFF
    return rising, falling


def row_nruns_bits(bits: torch.Tensor) -> torch.Tensor:
    """# maximal runs of each bitmap row = popcount of its rising edges."""
    rising, _ = _row_edges(bits)
    return _row_popcount(rising)


def _row_runs_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Bitmap rows -> packed run-pair rows: one Algorithm-2 extraction over
    ``rising | falling'`` yields ``s0, e0+1, s1, e1+1, ...``; a run ending
    at 65535 has no falling' bit, so its implicit end is 2^16."""
    rising, falling = _row_edges(bits)
    edges = rising | falling
    pos = row_bits_to_array(edges)
    n_edges = _row_popcount(edges)[:, None]
    nr = _row_popcount(rising)[:, None]
    k = torch.arange(MAX_RUNS, device=bits.device)
    s = pos[:, 2 * k]
    e1 = torch.where(2 * k + 1 < n_edges,
                     pos[:, torch.clamp(2 * k + 1, max=ROW_WORDS - 1)],
                     CHUNK_SIZE)
    lm1 = e1 - 1 - s
    live = k < nr
    return torch.stack([torch.where(live, s, 0xFFFF),
                        torch.where(live, lm1, 0xFFFF)],
                       dim=2).reshape(-1, ROW_WORDS)


def _runs_from_array_rows(vals: torch.Tensor, card: torch.Tensor):
    """Packed sorted array rows -> packed run-pair rows + run counts
    (adjacency-difference run detection, two O(4096) scatters per row)."""
    C = vals.shape[0]
    v = vals
    slot = _slots(v.device)[None, :]
    valid = slot < card[:, None]
    neg2 = _fill((C, 1), -2, v)
    prev = torch.cat([neg2, v[:, :-1]], 1)
    nxt = torch.cat([v[:, 1:], neg2], 1)
    isstart = valid & (v != prev + 1)
    isend = valid & ((slot + 1 >= card[:, None]) | (nxt != v + 1))
    rid = torch.cumsum(isstart.to(torch.int32), 1) - 1
    starts = torch.zeros((C, MAX_RUNS + 1), dtype=torch.int32,
                         device=v.device)
    fits = rid < MAX_RUNS            # runs past the row's 2048 pairs drop
    starts.scatter_add_(
        1, torch.where(isstart & fits, rid, MAX_RUNS).long(), v)
    pairs = _fill((C, ROW_WORDS + 1), 0xFFFF, v)
    pairs.scatter_(1, torch.where(isstart & fits, 2 * rid, ROW_WORDS).long(),
                   v)
    lm1 = v - torch.gather(starts, 1, rid.clamp(0, MAX_RUNS - 1).long())
    pairs.scatter_(1, torch.where(isend & fits, 2 * rid + 1,
                                  ROW_WORDS).long(), lm1)
    return pairs[:, :ROW_WORDS], isstart.sum(1, dtype=torch.int32)


def _arrays_from_runs_rows(pairs: torch.Tensor,
                           card: torch.Tensor) -> torch.Tensor:
    """Packed run-pair rows -> packed sorted array rows (per-slot search of
    the run-length prefix sums)."""
    C = pairs.shape[0]
    p = pairs.reshape(C, MAX_RUNS, 2)
    s, ln = p[..., 0], p[..., 1]
    valid = (s + ln) < CHUNK_SIZE
    lens = torch.where(valid, ln + 1, 0).to(torch.int64)
    cum = torch.cumsum(lens, 1)
    k = torch.arange(ROW_WORDS, device=pairs.device)
    r = torch.searchsorted(cum, k.expand(C, ROW_WORDS).contiguous(),
                           right=True)
    r_c = torch.clamp(r, max=MAX_RUNS - 1)
    base = torch.gather(cum, 1, r_c) - torch.gather(lens, 1, r_c)
    val = torch.gather(s, 1, r_c) + k - base
    return torch.where(k < card[:, None], val, 0xFFFF).to(torch.int32)


def _lift_rows(data: torch.Tensor, card: torch.Tensor,
               kind: torch.Tensor) -> torch.Tensor:
    """Bitmap-domain view of raw rows (empty -> zeros): arrays scatter their
    packed values, runs scatter their coverage, bitmaps pass through.
    int16 rows in, i32[M, 4096] words out."""
    out = widen(data) * (kind == KIND_BITMAP)[:, None].to(torch.int32)
    for k, lift in ((KIND_ARRAY, _D.array_coverage_by_scatter),
                    (KIND_RUN, _D.coverage_by_scatter)):
        rows = _rows_where(kind == k)
        if rows.numel():
            out[rows] = lift(widen(data[rows]), card[rows])
    return out



# =============================================================================
# canonicalization
# =============================================================================

def _finalize(keys, card, form, arr_rows, bits_rows, runs_rows, runs_nr
              ) -> RoaringSlab:
    """Canonicalization + assembly: each computed row arrives as a packed
    array, bitmap-domain words or packed run pairs (i32 values);
    best-of-three picks its kind, the conversions run over just the rows
    that need them, dead rows are keyed out and rows re-sorted (stable) so
    live keys lead."""
    dev = card.device
    M = card.shape[0]
    is_af = form == FORM_ARRAY
    is_bf = form == FORM_BITS
    is_rf = form == FORM_RUNS
    slot = _slots(dev)[None, :]

    pairs_from_arr = _fill((M, ROW_WORDS), 0xFFFF, card)
    nr_arr = torch.zeros_like(card)
    rows = _rows_where(is_af & (card > 0))
    if rows.numel():
        pairs_from_arr[rows], nr_arr[rows] = _runs_from_array_rows(
            arr_rows[rows], card[rows])
    nr_bits = torch.zeros_like(card)
    rows = _rows_where(is_bf)
    if rows.numel():
        nr_bits[rows] = row_nruns_bits(bits_rows[rows])
    nr = torch.where(is_af, nr_arr, torch.where(is_bf, nr_bits, runs_nr))
    kind = _pick_kind(card, nr)

    arrs = torch.zeros((M, ROW_WORDS), dtype=torch.int32, device=dev)
    rows = _rows_where(is_bf & (kind == KIND_ARRAY))
    if rows.numel():
        arrs[rows] = row_bits_to_array(bits_rows[rows])
    arr_from_bits = torch.where(slot < card[:, None], arrs, 0xFFFF)
    runs_from_bits = _fill((M, ROW_WORDS), 0xFFFF, card)
    rows = _rows_where(is_bf & (kind == KIND_RUN))
    if rows.numel():
        runs_from_bits[rows] = _row_runs_from_bits(bits_rows[rows])
    arr_from_runs = _fill((M, ROW_WORDS), 0xFFFF, card)
    rows = _rows_where(is_rf & (kind == KIND_ARRAY))
    if rows.numel():
        arr_from_runs[rows] = _arrays_from_runs_rows(runs_rows[rows],
                                                     card[rows])
    # a run-form row canonicalizes to bitmap only at the 4*nr == 8192 tie
    bits_from_runs = torch.zeros((M, ROW_WORDS), dtype=torch.int32,
                                 device=dev)
    rows = _rows_where(is_rf & (kind == KIND_BITMAP))
    if rows.numel():
        bits_from_runs[rows] = _D.coverage_by_scatter(runs_rows[rows])

    c = lambda m: m[:, None]                               # noqa: E731
    arr_final = torch.where(c(is_bf), arr_from_bits,
                            torch.where(c(is_rf), arr_from_runs, arr_rows))
    run_final = torch.where(c(is_af), pairs_from_arr,
                            torch.where(c(is_bf), runs_from_bits, runs_rows))
    bits_final = torch.where(c(is_rf), bits_from_runs, bits_rows)
    data = torch.where(c(kind == KIND_BITMAP), bits_final,
                       torch.where(c(kind == KIND_RUN), run_final, arr_final))
    live = kind != KIND_EMPTY
    out_keys = torch.where(live, keys, KEY_SENTINEL).to(torch.int32)
    order = torch.argsort(out_keys, stable=True)
    return RoaringSlab(keys=out_keys[order],
                       card=torch.where(live, card, 0)[order].to(torch.int32),
                       kind=kind[order], data=narrow(data[order]))


def _finalize_rows(keys, data, card, kind) -> RoaringSlab:
    """Row state (int16 data) -> canonical RoaringSlab: the single deferred
    best-of-three pass."""
    form = torch.where(kind == KIND_BITMAP, FORM_BITS,
                       torch.where(kind == KIND_RUN, FORM_RUNS, FORM_ARRAY))
    nr = _rows_nruns(data, kind)
    d = widen(data)
    return _finalize(keys, card, form, d, d, d, nr)


# =============================================================================
# row-state algebra: (data int16[M, 4096], card i32[M], kind i32[M]) of
# key-aligned rows; outputs carry deferred kinds {EMPTY, ARRAY, BITMAP}
# =============================================================================

def _row_merge_sparse(da, ca, db, cb, *, xor: bool):
    """Array x array union/xor by sorted merge of the two packed prefixes
    (i32 rows); only meaningful when card_a + card_b <= 4096."""
    INVALID = 1 << 17
    slot = _slots(da.device)[None, :]
    ia = torch.where(slot < ca[:, None], da, INVALID)
    ib = torch.where(slot < cb[:, None], db, INVALID)
    cat = torch.sort(torch.cat([ia, ib], 1), dim=1).values
    M = cat.shape[0]
    prev = torch.cat([_fill((M, 1), -1, cat), cat[:, :-1]], 1)
    nxt = torch.cat([cat[:, 1:], _fill((M, 1), -2, cat)], 1)
    keep = (cat != prev) & (cat < INVALID)
    if xor:
        keep = keep & (cat != nxt)
    h = keep.to(torch.int32)
    rank = torch.cumsum(h, 1) - h
    idx = torch.where(keep & (rank < ROW_WORDS), rank, ROW_WORDS).long()
    row = _fill((M, ROW_WORDS + 1), 0xFFFF, cat)
    row.scatter_(1, idx, cat)
    return row[:, :ROW_WORDS], h.sum(1, dtype=torch.int32)


def _or_rows(da, ca, ka, db, cb, kb, *, xor: bool = False,
             defer_card: bool = False):
    """One OR/XOR combine step over key-aligned row pairs -> row state.

    Routed by ``dispatch.union_route``: array pairs whose merged size stays
    under the threshold merge in array domain; every other live pair goes
    through the bitmap domain with a fused popcount. ``defer_card=True``
    leaves the ``CHUNK_SIZE`` upper bound on bitmap-path rows (Algorithm
    4's deferred cardinality; ``_recount_bitmap_rows`` fixes them at the
    root).
    """
    M = ka.shape[0]
    small, use_bitmap = _D.union_route(ka, kb, ca, cb, ARRAY_MAX)
    merge_rows = _fill((M, ROW_WORDS), 0xFFFF, ca)
    merge_card = torch.zeros_like(ca)
    rows = _rows_where(small)
    if rows.numel():
        merge_rows[rows], merge_card[rows] = _row_merge_sparse(
            widen(da[rows]), ca[rows], widen(db[rows]), cb[rows], xor=xor)
    bits = torch.zeros((M, ROW_WORDS), dtype=torch.int32, device=ca.device)
    bcard = torch.zeros_like(ca)
    rows = _rows_where(use_bitmap)
    if rows.numel():
        x = _lift_rows(da[rows], ca[rows], ka[rows])
        y = _lift_rows(db[rows], cb[rows], kb[rows])
        bits[rows] = (x ^ y) if xor else (x | y)
        bcard[rows] = (torch.full_like(rows, CHUNK_SIZE, dtype=torch.int32)
                       if defer_card else _row_popcount(bits[rows]))
    card = torch.where(use_bitmap, bcard, merge_card)
    data = torch.where(use_bitmap[:, None], bits, merge_rows)
    kind = torch.where(card == 0, KIND_EMPTY,
                       torch.where(use_bitmap, KIND_BITMAP, KIND_ARRAY))
    return narrow(data), card, kind.to(torch.int32)


def _or_rows_deferred(da, ca, ka, db, cb, kb):
    return _or_rows(da, ca, ka, db, cb, kb, defer_card=True)


def _recount_bitmap_rows(data, card, kind):
    """Exact cards for word rows at the root of a deferred-cardinality OR
    tree (one popcount pass over the bitmap rows)."""
    out = card.clone()
    rows = _rows_where(kind == KIND_BITMAP)
    if rows.numel():
        out[rows] = _row_popcount(widen(data[rows]))
    return out


def _and_rows(da, ca, ka, db, cb, kb):
    """One AND combine step over key-aligned row pairs -> row state.

    The full 4x4 kind-dispatch grid through ``ops.intersect_dispatch``:
    mask-semantic cells compact the hit mask against the array side (output
    <= min(card) <= 4096, stays packed); bits-semantic cells — including
    run x run, computed as the coverage AND — stay word rows with the fused
    popcount cardinality.
    """
    from repro_torch.kernels.roaring import ops as _kops
    ra = _rows_nruns(da, ka)
    rb = _rows_nruns(db, kb)
    meta = _dispatch_meta(ka, kb, ca, cb, ra, rb)
    hits, card = _kops.intersect_dispatch(da, db, meta)
    bits_m = _D.out_mask("bits", ka, kb) | _D.route_mask("run_merge", ka, kb)
    src = torch.where(_D.out_mask("mask_b", ka, kb)[:, None], db, da)
    arr_rows = _compact_rows(widen(src), (hits == 1) & ~bits_m[:, None])
    data = torch.where(bits_m[:, None], hits, arr_rows)
    kind = torch.where(card == 0, KIND_EMPTY,
                       torch.where(bits_m, KIND_BITMAP, KIND_ARRAY))
    return data, card, kind.to(torch.int32)


def _andnot_rows(da, ca, ka, db, cb, kb):
    """One ANDNOT combine step (A \\ B per row pair) -> row state.

    ``dispatch.andnot_route``: array-A rows probe B in place whatever B's
    kind (binary search / bit probe / gallop-in-ranges — result <= card_a,
    stays packed); bitmap- and run-A rows take the bitmap-domain pass.
    """
    M = ka.shape[0]
    probe_a, lift_a = _D.andnot_route(ka, kb)
    rb = _rows_nruns(db, kb)
    slot = _slots(ca.device)[None, :]
    keep = torch.zeros((M, ROW_WORDS), dtype=torch.bool, device=ca.device)
    rows = _rows_where(probe_a)
    if rows.numel():
        dav = widen(da[rows])
        in_b = torch.zeros_like(dav, dtype=torch.bool)
        kbr = kb[rows]
        for k in (KIND_ARRAY, KIND_BITMAP, KIND_RUN):
            sub = _rows_where(kbr == k)
            if not sub.numel():
                continue
            v = dav[sub]
            dbv = widen(db[rows[sub]])
            if k == KIND_ARRAY:
                pos = torch.searchsorted(dbv, v)
                pos_c = pos.clamp(0, ROW_WORDS - 1)
                in_b[sub] = ((torch.gather(dbv, 1, pos_c) == v)
                             & (pos < cb[rows[sub]][:, None]))
            elif k == KIND_BITMAP:
                word = torch.gather(dbv, 1, (v >> 4).long())
                in_b[sub] = ((word >> (v & 15)) & 1) == 1
            else:
                in_b[sub] = _D._run_covered(dbv, rb[rows[sub]], v)
        keep[rows] = (slot < ca[rows][:, None]) & ~in_b
    arr_rows = _compact_rows(widen(da), keep)
    acard = keep.sum(1, dtype=torch.int32)
    bits = torch.zeros((M, ROW_WORDS), dtype=torch.int32, device=ca.device)
    bcard = torch.zeros_like(ca)
    rows = _rows_where(lift_a)
    if rows.numel():
        x = _lift_rows(da[rows], ca[rows], ka[rows])
        y = _lift_rows(db[rows], cb[rows], kb[rows])
        bits[rows] = x & ~y & 0xFFFF
        bcard[rows] = _row_popcount(bits[rows])
    card = torch.where(lift_a, bcard, acard)
    data = torch.where(lift_a[:, None], narrow(bits), arr_rows)
    kind = torch.where(card == 0, KIND_EMPTY,
                       torch.where(lift_a, KIND_BITMAP, KIND_ARRAY))
    return data, card, kind.to(torch.int32)


def _tree_reduce_rows(data, card, kind, combine=_or_rows):
    """Log-depth segmented reduction over the leading (slab) axis: each
    level pairs adjacent slabs and runs one flattened ``combine`` over
    ``(N/2) * C`` rows, carrying the odd tail unchanged."""
    C, W = data.shape[1], data.shape[2]
    while data.shape[0] > 1:
        n = data.shape[0]
        half = n // 2
        ev = slice(0, 2 * half, 2)
        od = slice(1, 2 * half, 2)
        d, c, k = combine(
            data[ev].reshape(half * C, W), card[ev].reshape(half * C),
            kind[ev].reshape(half * C),
            data[od].reshape(half * C, W), card[od].reshape(half * C),
            kind[od].reshape(half * C))
        d = d.reshape(half, C, W)
        c = c.reshape(half, C)
        k = k.reshape(half, C)
        if n % 2:
            d = torch.cat([d, data[2 * half:]], 0)
            c = torch.cat([c, card[2 * half:]], 0)
            k = torch.cat([k, kind[2 * half:]], 0)
        data, card, kind = d, c, k
    return data[0], card[0], kind[0]


# =============================================================================
# host bridges and export
# =============================================================================

def from_roaring(rb, capacity: int, device) -> RoaringSlab:
    """A host ``py_roaring.RoaringBitmap`` -> slab with the container kinds
    preserved exactly."""
    from repro_torch.core import py_roaring as pr

    if len(rb.keys) > capacity:
        raise ValueError(f"{len(rb.keys)} containers exceed capacity "
                         f"{capacity}")
    keys = np.full((capacity,), KEY_SENTINEL, np.int32)
    card = np.zeros((capacity,), np.int32)
    kind = np.zeros((capacity,), np.int32)
    data = np.zeros((capacity, ROW_WORDS), np.uint16)
    for i, (k, c) in enumerate(zip(rb.keys, rb.containers)):
        keys[i] = k
        card[i] = c.cardinality
        if isinstance(c, pr.RunContainer):
            kind[i] = KIND_RUN
            row = np.full((ROW_WORDS,), 0xFFFF, np.uint16)
            row[0:2 * c.n_runs:2] = c.starts.astype(np.uint16)
            row[1:2 * c.n_runs:2] = c.lengths.astype(np.uint16)
            data[i] = row
        elif isinstance(c, pr.BitmapContainer):
            kind[i] = KIND_BITMAP
            data[i] = c.words.view(np.uint16)        # little-endian u64 -> u16
        else:
            kind[i] = KIND_ARRAY
            row = np.full((ROW_WORDS,), 0xFFFF, np.uint16)
            row[: c.arr.size] = c.arr
            data[i] = row
    return RoaringSlab(
        keys=torch.from_numpy(keys).to(device),
        card=torch.from_numpy(card).to(device),
        kind=torch.from_numpy(kind).to(device),
        data=torch.from_numpy(data.view(np.int16)).to(device))


def to_roaring(slab: RoaringSlab):
    """Slab -> host ``py_roaring.RoaringBitmap``, kind-preserving (the
    exact inverse of ``from_roaring``)."""
    from repro_torch.core import py_roaring as pr

    keys = slab.keys.cpu().numpy()
    card = slab.card.cpu().numpy()
    kind = slab.kind.cpu().numpy()
    data = slab.data.cpu().numpy().view(np.uint16)
    rb = pr.RoaringBitmap()
    for i in range(keys.shape[0]):
        if kind[i] == KIND_EMPTY:
            continue
        if kind[i] == KIND_ARRAY:
            c = pr.ArrayContainer(data[i, : card[i]].copy())
        elif kind[i] == KIND_BITMAP:
            c = pr.BitmapContainer(np.ascontiguousarray(data[i]).view(
                np.uint64).copy(), cardinality=int(card[i]))
        else:
            p = data[i].reshape(MAX_RUNS, 2).astype(np.int64)
            valid = (p[:, 0] + p[:, 1]) < CHUNK_SIZE
            c = pr.RunContainer(p[valid, 0], p[valid, 1])
        rb.keys.append(int(keys[i]))
        rb.containers.append(c)
    return rb


_WIDEN_ROWS = 1024      # rows widened at a time by ``to_indices``


def to_indices(slab: RoaringSlab, max_out: Optional[int] = None):
    """Slab -> (sorted values i64[max_out], valid bool[max_out]); values
    past the cardinality are 0. ``max_out`` defaults to the cardinality.
    Rows widen to one bool per value ``_WIDEN_ROWS`` at a time, so a large
    slab (a gradient leaf's 9,000 rows) needs no [C, 2^16] buffer."""
    bits = _lift_rows(slab.data, slab.card, slab.kind)
    C = bits.shape[0]
    shifts = torch.arange(16, dtype=torch.int32, device=bits.device)
    keys = slab.keys.to(torch.int64)
    vals = []
    for lo in range(0, max(C, 1), _WIDEN_ROWS):
        part = bits[lo:lo + _WIDEN_ROWS]
        bitmat = ((part[:, :, None] >> shifts) & 1).reshape(
            part.shape[0], CHUNK_SIZE) == 1
        r, pos = torch.nonzero(bitmat, as_tuple=True)
        vals.append((keys[lo + r] << CHUNK_BITS) + pos)
    vals = vals[0] if len(vals) == 1 else torch.cat(vals)
    if max_out is None:
        max_out = vals.numel()
    out = torch.zeros((max_out,), dtype=torch.int64, device=bits.device)
    n = min(max_out, vals.numel())
    out[:n] = vals[:n]
    valid = torch.arange(max_out, device=bits.device) < vals.numel()
    return out, valid



# =============================================================================
# construction
# =============================================================================

def empty(capacity: int, device) -> RoaringSlab:
    """All-empty slab: every row ``KIND_EMPTY``, card 0, key
    ``KEY_SENTINEL``, zero payload — the identity of ``slab_or`` and
    ``union_many_slabs``."""
    return RoaringSlab(
        keys=torch.full((capacity,), KEY_SENTINEL, dtype=torch.int32,
                        device=device),
        card=torch.zeros((capacity,), dtype=torch.int32, device=device),
        kind=torch.zeros((capacity,), dtype=torch.int32, device=device),
        data=torch.zeros((capacity, ROW_WORDS), dtype=torch.int16,
                         device=device))


def from_indices(idx: torch.Tensor, valid: torch.Tensor,
                 capacity: int) -> RoaringSlab:
    """Slab from (padded) *sorted unique* integer indices on the tensors'
    device: ``idx`` i64/i32[M] ascending with invalid entries at the end
    (``valid`` false). Elements sharing high 16 bits land in one container
    (array up to 4096 values, bitmap above); containers past ``capacity``
    are dropped."""
    dev = idx.device
    idx = idx.to(torch.int64)
    valid = valid.to(torch.bool)
    M = idx.shape[0]
    hi = torch.where(valid, idx >> CHUNK_BITS, KEY_SENTINEL)
    lo = (idx & (CHUNK_SIZE - 1)).to(torch.int32)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       hi[1:] != hi[:-1]]) & valid
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    keep = valid & (seg < capacity)               # containers past capacity
    seg = torch.where(keep, seg, capacity)
    counts = torch.zeros((capacity + 1,), dtype=torch.int32, device=dev)
    counts.index_add_(0, seg, torch.ones_like(seg, dtype=torch.int32))
    counts = counts[:capacity]
    keys = torch.full((capacity + 1,), KEY_SENTINEL, dtype=torch.int64,
                      device=dev)
    keys[torch.where(first & keep, seg, capacity)] = torch.where(
        first & keep, hi, KEY_SENTINEL)
    keys = torch.where(counts > 0, keys[:capacity], KEY_SENTINEL).to(
        torch.int32)
    seg_start = torch.cumsum(counts, 0) - counts
    rank_ = (torch.arange(M, device=dev)
             - seg_start[seg.clamp(max=max(capacity - 1, 0))])
    in_arr = keep & (rank_ < ROW_WORDS)
    flat = (capacity + 1) * ROW_WORDS              # last row: the drop bin
    arr = torch.zeros((flat,), dtype=torch.int32, device=dev)
    arr.index_put_((torch.where(in_arr, seg * ROW_WORDS + rank_, flat - 1),),
                   torch.where(in_arr, lo, 0), accumulate=True)
    bits = torch.zeros((flat,), dtype=torch.int32, device=dev)
    bits.index_put_((torch.where(keep, seg * ROW_WORDS + (lo >> 4),
                                 flat - 1),),
                    torch.where(keep, 1 << (lo & 15), 0), accumulate=True)
    arr = arr.reshape(capacity + 1, ROW_WORDS)[:capacity]
    bits = bits.reshape(capacity + 1, ROW_WORDS)[:capacity] & 0xFFFF
    is_bitmap = counts > ARRAY_MAX
    arr = torch.where(_slots(dev)[None, :] < counts[:, None], arr, 0xFFFF)
    data = torch.where(is_bitmap[:, None], bits, arr)
    kind = torch.where(counts == 0, KIND_EMPTY,
                       torch.where(is_bitmap, KIND_BITMAP, KIND_ARRAY))
    return RoaringSlab(keys=keys, card=counts, kind=kind.to(torch.int32),
                       data=narrow(data))


def from_dense_array(values, capacity: int, max_elems: int,
                     device) -> RoaringSlab:
    """Host numpy values -> slab on ``device`` (deduplicated, sorted, padded
    to ``max_elems``)."""
    v = np.unique(np.asarray(values, dtype=np.int64))
    if v.size > max_elems:
        raise ValueError(f"{v.size} distinct values exceed max_elems "
                         f"{max_elems}")
    idx = np.zeros((max_elems,), np.int64)
    idx[: v.size] = v
    if v.size:
        idx[v.size:] = v[-1]           # keep the padded tail sorted
    valid = np.arange(max_elems) < v.size
    return from_indices(torch.from_numpy(idx).to(device),
                        torch.from_numpy(valid).to(device), capacity)


def from_ranges(ranges, capacity: int, device) -> RoaringSlab:
    """Run-row slab from half-open ``[start, end)`` integer ranges (run
    containers built directly, no element materialization)."""
    from repro_torch.core import py_roaring as pr

    return from_roaring(pr.RoaringBitmap.from_ranges(ranges), capacity,
                        device)


def slab_run_optimize(slab: RoaringSlab) -> RoaringSlab:
    """``runOptimize``: re-canonicalize every row best-of-three."""
    return _finalize_rows(slab.keys, slab.data, slab.card, slab.kind)


def extract_row(slab: RoaringSlab, r: int, max_out: int = ARRAY_MAX):
    """Packed sorted values of container ``r`` (Algorithm 2 on one row):
    (values i32[max_out], valid bool[max_out]); zeros past the card."""
    bits = _lift_rows(slab.data[r:r + 1], slab.card[r:r + 1],
                      slab.kind[r:r + 1])
    arr = row_bits_to_array(bits)[0]
    valid = _slots(bits.device) < slab.card[r]
    return arr[:max_out], valid[:max_out]


# =============================================================================
# membership / rank / select (batched over query values)
# =============================================================================

def _locate(slab: RoaringSlab, x: torch.Tensor):
    """(row, key hit, low 16 bits) of each value of ``x`` (flattened)."""
    x = x.reshape(-1).to(torch.int64)
    hi = (x >> CHUNK_BITS).to(torch.int32)
    lo = (x & (CHUNK_SIZE - 1)).to(torch.int32)
    C = slab.keys.shape[0]
    row = torch.searchsorted(slab.keys.contiguous(), hi.contiguous())
    row_c = row.clamp(max=C - 1)
    return row_c, slab.keys[row_c] == hi, lo


def contains(slab: RoaringSlab, queries: torch.Tensor) -> torch.Tensor:
    """Batched membership (paper S3): first-level binary search of the
    keys, then per kind a bitmap word probe, a 13-step lower bound over the
    packed array, or a 12-step search of the run starts — one gathered word
    (two for runs) per step, never a whole row."""
    q = torch.as_tensor(queries, device=slab.keys.device)
    row, key_hit, lo = _locate(slab, q)
    card = slab.card[row]
    kind = slab.kind[row]

    def at(i):
        return widen(slab.data[row, i.long()])

    bit_hit = ((at(lo >> 4) >> (lo & 15)) & 1) == 1
    l = torch.zeros_like(lo)
    h = card.clone()
    for _ in range(13):
        mid = (l + h) // 2
        go_right = at(mid.clamp(0, ROW_WORDS - 1)) < lo
        l, h = torch.where(go_right, mid + 1, l), torch.where(go_right, h,
                                                              mid)
    arr_hit = (l < card) & (at(l.clamp(0, ROW_WORDS - 1)) == lo)
    l = torch.zeros_like(lo)
    h = torch.full_like(lo, MAX_RUNS)
    for _ in range(12):
        open_ = l < h
        mid = (l + h) // 2
        mid_c = (2 * mid).clamp(0, ROW_WORDS - 2)
        s, ln = at(mid_c), at(mid_c + 1)
        key = torch.where(s + ln < CHUNK_SIZE, s, CHUNK_SIZE)
        go_right = open_ & (key <= lo)
        l, h = (torch.where(go_right, mid + 1, l),
                torch.where(open_ & ~go_right, mid, h))
    ri = (l - 1).clamp(0, MAX_RUNS - 1)
    rs, rln = at(2 * ri), at(2 * ri + 1)
    run_hit = (l > 0) & (rs + rln < CHUNK_SIZE) & (lo <= rs + rln)
    hit = torch.where(kind == KIND_BITMAP, bit_hit,
                      torch.where(kind == KIND_ARRAY, arr_hit,
                                  (kind == KIND_RUN) & run_hit))
    return (hit & key_hit).reshape(q.shape)


def rank(slab: RoaringSlab, x) -> torch.Tensor:
    """# elements <= x (per value of ``x``): whole-container counters below
    x's key plus the popcount of x's container up to x."""
    x = torch.as_tensor(x, device=slab.keys.device)
    row, hit, lo = _locate(slab, x)
    hi = (x.reshape(-1).to(torch.int64) >> CHUNK_BITS)
    full = torch.where(slab.keys[None, :].to(torch.int64) < hi[:, None],
                       slab.card[None, :], 0).sum(1, dtype=torch.int64)
    bits = _lift_rows(slab.data[row], slab.card[row], slab.kind[row])
    word = (lo >> 4)[:, None]
    partial = _row_popcount(torch.where(_slots(bits.device)[None, :] < word,
                                        bits, 0))
    last = torch.gather(bits, 1, word.long())[:, 0] & (
        (2 << (lo & 15)) - 1)
    in_row = partial + _D.popcount16(last)
    return (full + torch.where(hit, in_row, 0)).reshape(x.shape)


def slab_select(slab: RoaringSlab, j) -> torch.Tensor:
    """Value of the j-th (0-based) smallest element (per value of ``j``);
    -1 out of range. The container from the cardinality prefix sums, then
    per kind a direct gather (array), a search of the run-length prefix
    sums (run) or a bit-rank over the one row (bitmap)."""
    j = torch.as_tensor(j, device=slab.keys.device)
    jf = j.reshape(-1).to(torch.int64)
    csum = torch.cumsum(slab.card.to(torch.int64), 0)
    C = slab.keys.shape[0]
    total = csum[-1]
    row = torch.searchsorted(csum, jf, right=True).clamp(max=C - 1)
    before = torch.where(row > 0, csum[(row - 1).clamp(min=0)], 0)
    j_in = jf - before
    kind = slab.kind[row]
    drow = widen(slab.data[row])
    arr_val = torch.gather(drow, 1, j_in.clamp(0, ROW_WORDS - 1)[:, None])[:,
                                                                          0]
    p = drow.reshape(-1, MAX_RUNS, 2)
    s, ln = p[..., 0], p[..., 1]
    lens = torch.where(s + ln < CHUNK_SIZE, ln + 1, 0).to(torch.int64)
    lcum = torch.cumsum(lens, 1)
    r = torch.searchsorted(lcum, j_in[:, None], right=True).clamp(
        max=MAX_RUNS - 1)
    run_val = (torch.gather(s, 1, r)[:, 0] + j_in
               - (torch.gather(lcum, 1, r) - torch.gather(lens, 1, r))[:, 0])
    bit_pos = torch.zeros_like(jf)
    sel = _rows_where(kind == KIND_BITMAP)
    if sel.numel():
        shifts = torch.arange(16, dtype=torch.int32, device=drow.device)
        flat = ((drow[sel][:, :, None] >> shifts) & 1).reshape(
            sel.numel(), CHUNK_SIZE)
        bit_pos[sel] = torch.searchsorted(torch.cumsum(flat, 1),
                                          (j_in[sel] + 1)[:, None])[:, 0]
    lo_val = torch.where(kind == KIND_ARRAY, arr_val.to(torch.int64),
                         torch.where(kind == KIND_RUN, run_val, bit_pos))
    val = (slab.keys[row].to(torch.int64) << CHUNK_BITS) + lo_val
    ok = (jf >= 0) & (jf < total)
    return torch.where(ok, val, -1).reshape(j.shape)


# =============================================================================
# pairwise set algebra (canonical outputs)
# =============================================================================

def _merge_keys(a: RoaringSlab, b: RoaringSlab, capacity: int):
    return _merge_keys_many([a.keys, b.keys], capacity)


def _intersect_keys(a: RoaringSlab, b: RoaringSlab, capacity: int):
    """Keys present in both slabs (the only rows an AND can populate)."""
    Cb = b.keys.shape[0]
    pos = torch.searchsorted(b.keys.contiguous(), a.keys.contiguous())
    hit = ((b.keys[pos.clamp(max=Cb - 1)] == a.keys)
           & (a.keys != KEY_SENTINEL))
    vals = torch.sort(torch.where(hit, a.keys, KEY_SENTINEL)).values
    return _pad_keys(vals.to(torch.int32), capacity)


def _run_merge_rows(da: torch.Tensor, db: torch.Tensor):
    """run x run intersection in run domain over i32 rows: every output run
    closes at an input run end covered by the other side, so the <= na+nb
    candidates come from two searches (one per input end), deduplicated by
    a strict tie-break and compacted by one sort — never the 2^16 domain.
    Returns (pairs i32[M, 4096], card, n_out); a row whose ``n_out``
    exceeds the 2048-pair capacity needs the coverage form instead."""
    M = da.shape[0]
    BIG = 1 << 17
    pa, pb = da.reshape(M, MAX_RUNS, 2), db.reshape(M, MAX_RUNS, 2)
    sa, la = pa[..., 0], pa[..., 1]
    sb, lb = pb[..., 0], pb[..., 1]
    va, vb = (sa + la) < CHUNK_SIZE, (sb + lb) < CHUNK_SIZE
    ea, eb = sa + la, sb + lb
    sa_p = torch.where(va, sa, BIG).contiguous()
    sb_p = torch.where(vb, sb, BIG).contiguous()
    j = torch.searchsorted(sb_p, ea.contiguous(), right=True) - 1
    jc = j.clamp(0, MAX_RUNS - 1)
    av = va & (j >= 0) & (torch.gather(eb, 1, jc) >= ea)
    a_start = torch.maximum(sa, torch.gather(sb, 1, jc))
    i = torch.searchsorted(sa_p, eb.contiguous(), right=True) - 1
    ic = i.clamp(0, MAX_RUNS - 1)
    bv = vb & (i >= 0) & (torch.gather(ea, 1, ic) > eb)
    b_start = torch.maximum(sb, torch.gather(sa, 1, ic))
    starts = torch.cat([torch.where(av, a_start, BIG),
                        torch.where(bv, b_start, BIG)], 1)
    ends = torch.cat([torch.where(av, ea, 0), torch.where(bv, eb, 0)], 1)
    card = (torch.where(av, ea - a_start + 1, 0).sum(1, dtype=torch.int32)
            + torch.where(bv, eb - b_start + 1, 0).sum(1, dtype=torch.int32))
    n_out = (av.sum(1, dtype=torch.int32) + bv.sum(1, dtype=torch.int32))
    order = torch.argsort(starts, dim=1, stable=True)[:, :MAX_RUNS]
    ss = torch.gather(starts, 1, order)
    ee = torch.gather(ends, 1, order)
    live = torch.arange(MAX_RUNS, device=da.device)[None, :] < n_out[:, None]
    pairs = torch.stack([torch.where(live, ss, 0xFFFF),
                         torch.where(live, ee - ss, 0xFFFF)],
                        dim=2).reshape(M, ROW_WORDS)
    return pairs.to(torch.int32), card, n_out


def _run_merge_rows_lazy(da: torch.Tensor, db: torch.Tensor,
                         rr: torch.Tensor):
    """The run-domain merge over just the rows classified run x run (i32
    rows in). Returns (pairs, card, n_out, bits): rows the merge cannot
    hold (over 2048 output runs) get their coverage AND in ``bits``."""
    M = da.shape[0]
    pairs = _fill((M, ROW_WORDS), 0xFFFF, da)
    card = torch.zeros((M,), dtype=torch.int32, device=da.device)
    n_out = torch.zeros_like(card)
    bits = torch.zeros((M, ROW_WORDS), dtype=torch.int32, device=da.device)
    rows = _rows_where(rr)
    if rows.numel():
        pairs[rows], card[rows], n_out[rows] = _run_merge_rows(da[rows],
                                                               db[rows])
        over = rows[n_out[rows] > MAX_RUNS]
        if over.numel():
            bits[over] = (_D.coverage_by_scatter(da[over])
                          & _D.coverage_by_scatter(db[over]))
    return pairs, card, n_out, bits


def slab_and(a: RoaringSlab, b: RoaringSlab,
             capacity: Optional[int] = None) -> RoaringSlab:
    """A ∩ B over the registry's 4x4 dispatch grid: every cell but run x
    run through the dispatch kernel (``ops.intersect_dispatch``), run x run
    by the run-domain merge; one canonicalization. Capacity defaults to
    ``min(C_a, C_b)``."""
    from repro_torch.kernels.roaring import ops as _kops
    capacity = capacity or min(a.keys.shape[0], b.keys.shape[0])
    keys = _intersect_keys(a, b, capacity)
    da, ca, ka = _gather_raw(a, keys)
    db, cb, kb = _gather_raw(b, keys)
    ra, rb = _rows_nruns(da, ka), _rows_nruns(db, kb)
    rr = _D.route_mask("run_merge", ka, kb)
    # run x run rows are routed around the kernel (masked empty: skipped)
    meta = _dispatch_meta(torch.where(rr, KIND_EMPTY, ka),
                          torch.where(rr, KIND_EMPTY, kb), ca, cb, ra, rb)
    hits, kcard = _kops.intersect_dispatch(da, db, meta)
    pairs_rr, card_rr, nr_rr, bits_rr = _run_merge_rows_lazy(
        widen(da), widen(db), rr)
    mask_b = _D.out_mask("mask_b", ka, kb)
    mask_m = _D.out_mask("mask_a", ka, kb) | mask_b
    src = torch.where(mask_b[:, None], db, da)
    arr_rows = widen(_compact_rows(widen(src),
                                   (hits == 1) & mask_m[:, None]))
    card = torch.where(rr, card_rr, kcard)
    overflow = rr & (nr_rr > MAX_RUNS)
    form = torch.where(rr & ~overflow, FORM_RUNS,
                       torch.where(_D.out_mask("bits", ka, kb) | overflow,
                                   FORM_BITS, FORM_ARRAY))
    bits_rows = torch.where(rr[:, None], bits_rr, widen(hits))
    return _finalize(keys, card, form, arr_rows, bits_rows, pairs_rr, nr_rr)


def slab_and_card(a: RoaringSlab, b: RoaringSlab) -> torch.Tensor:
    """|A ∩ B| without a result slab: the dispatch kernel's per-row cards
    are the whole answer (run x run rows by its coverage AND)."""
    from repro_torch.kernels.roaring import ops as _kops
    keys = _intersect_keys(a, b, min(a.keys.shape[0], b.keys.shape[0]))
    da, ca, ka = _gather_raw(a, keys)
    db, cb, kb = _gather_raw(b, keys)
    meta = _dispatch_meta(ka, kb, ca, cb, _rows_nruns(da, ka),
                          _rows_nruns(db, kb))
    _, card = _kops.intersect_dispatch(da, db, meta)
    return card.sum(dtype=torch.int64)


def _total(s: RoaringSlab) -> torch.Tensor:
    return s.card.sum(dtype=torch.int64)


def slab_or_card(a: RoaringSlab, b: RoaringSlab) -> torch.Tensor:
    """|A ∪ B| by inclusion-exclusion on the counters."""
    return _total(a) + _total(b) - slab_and_card(a, b)


def slab_jaccard(a: RoaringSlab, b: RoaringSlab) -> torch.Tensor:
    """|A ∩ B| / |A ∪ B| as float32 (0 when both are empty)."""
    inter = slab_and_card(a, b)
    union = _total(a) + _total(b) - inter
    return torch.where(union > 0,
                       inter.to(torch.float32)
                       / union.clamp(min=1).to(torch.float32),
                       torch.zeros((), dtype=torch.float32,
                                   device=inter.device))


def stack_slabs(slabs) -> RoaringSlab:
    """Stack same-capacity slabs along a new leading axis."""
    return RoaringSlab(*(torch.stack(xs) for xs in zip(*slabs)))


def slab_and_many(query: RoaringSlab, slabs) -> RoaringSlab:
    """``query ∩ slab_i`` for each slab, stacked (one ``slab_and`` per
    member: each keeps its own key intersection and canonicalization)."""
    return stack_slabs([slab_and(query, s) for s in slabs])


def slab_and_card_many(query: RoaringSlab, slabs) -> torch.Tensor:
    """i64[N] of |query ∩ slab_i| (one dispatch launch per member)."""
    return torch.stack([slab_and_card(query, s) for s in slabs])


def _union_like(a: RoaringSlab, b: RoaringSlab, capacity: int,
                xor: bool) -> RoaringSlab:
    """OR / XOR: merge the key sets, one ``_or_rows`` step, canonicalize."""
    keys = _merge_keys(a, b, capacity)
    da, ca, ka = _gather_raw(a, keys)
    db, cb, kb = _gather_raw(b, keys)
    data, card, kind = _or_rows(da, ca, ka, db, cb, kb, xor=xor)
    return _finalize_rows(keys, data, card, kind)


def slab_or(a: RoaringSlab, b: RoaringSlab,
            capacity: Optional[int] = None) -> RoaringSlab:
    """A ∪ B (canonical). Capacity defaults to ``C_a + C_b``."""
    return _union_like(a, b, capacity or (a.keys.shape[0] + b.keys.shape[0]),
                       xor=False)


def slab_xor(a: RoaringSlab, b: RoaringSlab,
             capacity: Optional[int] = None) -> RoaringSlab:
    """A ⊕ B (symmetric difference). Capacity defaults to ``C_a + C_b``."""
    return _union_like(a, b, capacity or (a.keys.shape[0] + b.keys.shape[0]),
                       xor=True)


def slab_andnot(a: RoaringSlab, b: RoaringSlab,
                capacity: Optional[int] = None) -> RoaringSlab:
    """A \\ B: array-A rows probe B in place, the others take the bitmap
    domain. Capacity defaults to ``C_a``."""
    keys = _pad_keys(a.keys, capacity or a.keys.shape[0])
    da, ca, ka = _gather_raw(a, keys)
    db, cb, kb = _gather_raw(b, keys)
    data, card, kind = _andnot_rows(da, ca, ka, db, cb, kb)
    return _finalize_rows(keys, data, card, kind)


def union_many_slabs(slabs, capacity: int, device=None) -> RoaringSlab:
    """Algorithm 4: merge the key sets once, gather every slab's rows
    key-aligned in native form, reduce in ceil(log2 N) ``_or_rows`` levels
    with deferred cardinality, recount once and canonicalize once at the
    root. No slabs gives ``empty(capacity)`` on ``device``."""
    if not slabs:
        return empty(capacity, device)
    keys = _merge_keys_many([s.keys for s in slabs], capacity)
    gathered = [_gather_raw(s, keys) for s in slabs]
    data, card, kind = _tree_reduce_rows(
        torch.stack([g[0] for g in gathered]),
        torch.stack([g[1] for g in gathered]),
        torch.stack([g[2] for g in gathered]), _or_rows_deferred)
    card = _recount_bitmap_rows(data, card, kind)
    return _finalize_rows(keys, data, card, kind)


# =============================================================================
# the pre-dispatch bitmap-domain path (A/B baseline and cross-check)
# =============================================================================

def _gather_rows(s: RoaringSlab, keys: torch.Tensor):
    """Bitmap-domain rows of ``s`` aligned to ``keys`` (zeros when
    absent), and the presence mask."""
    C = s.keys.shape[0]
    pos = torch.searchsorted(s.keys.contiguous(), keys.contiguous())
    pos_c = pos.clamp(max=C - 1)
    present = (s.keys[pos_c] == keys) & (keys != KEY_SENTINEL)
    bits = _lift_rows(s.data[pos_c], s.card[pos_c], s.kind[pos_c])
    return bits * present[:, None].to(torch.int32), present


def _binary_bits_op(a, b, word_op, capacity: int,
                    intersection: bool) -> RoaringSlab:
    """Lift every row to the 2^16-bit domain, apply the word op and
    canonicalize array / bitmap only (no run outputs): the full per-row
    bitmap-domain cost whatever the kinds."""
    keys = _merge_keys(a, b, capacity)
    bits_a, pa = _gather_rows(a, keys)
    bits_b, pb = _gather_rows(b, keys)
    bits = word_op(bits_a, bits_b) & 0xFFFF
    card = _row_popcount(bits)
    arr = torch.where(_slots(bits.device)[None, :] < card[:, None],
                      row_bits_to_array(bits), 0xFFFF)
    is_bitmap = card > ARRAY_MAX
    data = torch.where(is_bitmap[:, None], bits, arr)
    kind = torch.where(card == 0, KIND_EMPTY,
                       torch.where(is_bitmap, KIND_BITMAP, KIND_ARRAY))
    live = card > 0
    if intersection:
        live = live & pa & pb
        card = torch.where(live, card, 0)
        kind = torch.where(live, kind, KIND_EMPTY)
    keys = torch.where(live, keys, KEY_SENTINEL).to(torch.int32)
    order = torch.argsort(keys, stable=True)
    return RoaringSlab(keys=keys[order], card=card[order].to(torch.int32),
                       kind=kind[order].to(torch.int32),
                       data=narrow(data[order]))


def slab_and_bitmap_domain(a: RoaringSlab, b: RoaringSlab,
                           capacity: Optional[int] = None) -> RoaringSlab:
    """A ∩ B through the bitmap-domain path (benchmark baseline)."""
    return _binary_bits_op(
        a, b, torch.bitwise_and,
        capacity or min(a.keys.shape[0], b.keys.shape[0]) * 2,
        intersection=True)


def slab_or_bitmap_domain(a: RoaringSlab, b: RoaringSlab,
                          capacity: Optional[int] = None) -> RoaringSlab:
    """A ∪ B through the bitmap-domain path (benchmark baseline)."""
    return _binary_bits_op(
        a, b, torch.bitwise_or,
        capacity or (a.keys.shape[0] + b.keys.shape[0]), intersection=False)
