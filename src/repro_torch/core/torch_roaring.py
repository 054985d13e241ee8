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
best-of-three canonicalization (``_finalize``) are plain torch. Where the
reference guards an expensive pass with ``lax.cond``, this module computes
it over just the rows that need it (selected with ``torch.nonzero``); each
such selection is one host sync — a ``_finalize`` costs at most six, an
``_or_rows`` / ``_andnot_rows`` step two to four. Rows no pass touches get
the same fill values as in the reference, so results are byte-identical.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

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
    "RoaringSlab", "from_roaring", "to_roaring", "to_indices",
    "row_bits_to_array", "row_nruns_bits",
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
    """Indices of the true rows (one host sync)."""
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
    r, pos = torch.nonzero(bitmat, as_tuple=True)
    counts = bitmat.sum(1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(r.numel(), device=bits.device) - starts[r]
    keep = rank < ROW_WORDS
    out = torch.zeros((M, ROW_WORDS), dtype=torch.int32, device=bits.device)
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


def to_indices(slab: RoaringSlab, max_out: Optional[int] = None):
    """Slab -> (sorted values i64[max_out], valid bool[max_out]); values
    past the cardinality are 0. ``max_out`` defaults to the cardinality."""
    bits = _lift_rows(slab.data, slab.card, slab.kind)
    C = bits.shape[0]
    shifts = torch.arange(16, dtype=torch.int32, device=bits.device)
    bitmat = ((bits[:, :, None] >> shifts) & 1).reshape(C, CHUNK_SIZE) == 1
    r, pos = torch.nonzero(bitmat, as_tuple=True)
    vals = (slab.keys.to(torch.int64)[r] << CHUNK_BITS) + pos
    if max_out is None:
        max_out = vals.numel()
    out = torch.zeros((max_out,), dtype=torch.int64, device=bits.device)
    n = min(max_out, vals.numel())
    out[:n] = vals[:n]
    valid = torch.arange(max_out, device=bits.device) < vals.numel()
    return out, valid
