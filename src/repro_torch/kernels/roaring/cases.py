"""Seeded container rows that cover every kind and boundary.

The kernels are held against their plain versions on these rows, by the
tests and by ``chip_smoke.py``: arrays (300 values, 4095, 4096), bitmaps
(4097, dense), runs (few, one ending at 65535, one covering the whole
chunk) and the empty container. Every pair of them covers all nine pair
classes of ``dispatch.AND_TABLE`` plus dead pairs.

``container_pairs`` and ``array_pairs`` give the word-op and packed-array
kernels their own grids: bitmap-domain rows with card 0 / 1 / 4095 / 4096,
value 65,535, all-ones rows, one EMPTY side, and both-EMPTY pairs whose
payload is garbage; packed arrays with card 0 / 1 / 4095 / 4096, value
65,535 in both sides, and slots past card_a holding values.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from ...core import py_roaring as pr
from .dispatch import KIND_ARRAY, KIND_BITMAP, KIND_RUN, ROW_WORDS

__all__ = ["KIND_CASES", "container_row", "case_rows", "pair_grid",
           "container_pairs", "array_pairs", "CONTAINER_OPS"]

CONTAINER_OPS = ("and", "or", "xor", "andnot")

Row = Tuple[int, int, int, np.ndarray]     # kind, card, nruns, u16[4096]


def _ranges(rng, n, hi):
    """Union of ``n`` random short ranges below ``hi``."""
    starts = np.sort(rng.choice(hi - 64, n, replace=False))
    return np.unique(np.concatenate(
        [np.arange(s, s + rng.integers(1, 60)) for s in starts]))


def _pick(rng, n):
    return np.sort(rng.choice(1 << 16, n, replace=False))


# name -> (canonical kind, fn(rng) -> sorted unique u16 values)
KIND_CASES = {
    "array_small": (KIND_ARRAY,
                    lambda r: np.unique(r.integers(0, 1 << 16, 300))),
    "array_4095": (KIND_ARRAY, lambda r: _pick(r, 4095)),
    "array_4096": (KIND_ARRAY, lambda r: _pick(r, 4096)),
    "bitmap_4097": (KIND_BITMAP, lambda r: _pick(r, 4097)),
    "bitmap_dense": (KIND_BITMAP,
                     lambda r: np.unique(r.integers(0, 1 << 16, 30000))),
    "run_few": (KIND_RUN, lambda r: _ranges(r, 40, 1 << 16)),
    "run_to_65535": (KIND_RUN, lambda r: np.concatenate(
        [_ranges(r, 10, 60000), np.arange(65000, 1 << 16)])),
    "run_full": (KIND_RUN, lambda r: np.arange(1 << 16)),
}


def container_row(values) -> Row:
    """Canonical (best-of-three) container of u16 ``values`` -> (kind,
    card, nruns, u16[4096] raw row)."""
    rb = pr.RoaringBitmap.from_sorted_unique(
        np.asarray(values, np.int64)).run_optimize()
    if not rb.containers:
        return 0, 0, 0, np.zeros(ROW_WORDS, np.uint16)
    c = rb.containers[0]
    row = np.full(ROW_WORDS, 0xFFFF, np.uint16)
    if isinstance(c, pr.RunContainer):
        row[0:2 * c.n_runs:2] = c.starts
        row[1:2 * c.n_runs:2] = c.lengths
        return KIND_RUN, c.cardinality, c.n_runs, row
    if isinstance(c, pr.BitmapContainer):
        return KIND_BITMAP, c.cardinality, 0, c.words.view(np.uint16).copy()
    row[:c.arr.size] = c.arr
    return KIND_ARRAY, c.cardinality, 0, row


def case_rows(rng) -> Dict[str, Row]:
    """Every case of ``KIND_CASES`` (in name order, drawn from ``rng``) and
    ``"empty"``, as container rows."""
    out = {n: container_row(KIND_CASES[n][1](rng)) for n in sorted(KIND_CASES)}
    out["empty"] = container_row([])
    return out


def pair_grid(rows: Dict[str, Row], names_a: Sequence[str],
              names_b: Sequence[str]):
    """Every (a, b) pair of the named rows -> (A u16[P, 4096], B u16[P,
    4096], meta i32[6P]) in the kernels' key-aligned pair layout."""
    A, B, meta = [], [], []
    for na in names_a:
        for nb in names_b:
            ka, ca, ra, da = rows[na]
            kb, cb, rb, db = rows[nb]
            A.append(da)
            B.append(db)
            meta += [ka, kb, ca, cb, ra, rb]
    return np.stack(A), np.stack(B), np.asarray(meta, np.int32)


def _words(values) -> np.ndarray:
    """u16 values -> the 4096 u16 words of their bitmap-domain row."""
    bits = np.zeros(1 << 16, np.uint8)
    bits[np.asarray(values, np.int64)] = 1
    return np.packbits(bits, bitorder="little").view(np.uint16).copy()


def container_pairs(rng):
    """Every pair of the word-op kernel's rows -> (A u16[P, 4096], B u16[P,
    4096], kinds i32[2P] interleaved (kind_a, kind_b))."""
    rows = {   # name -> (kind tag, bitmap-domain words)
        "empty": (0, np.zeros(ROW_WORDS, np.uint16)),
        "garbage": (0, rng.integers(0, 1 << 16, ROW_WORDS).astype(np.uint16)),
        "one_65535": (KIND_ARRAY, _words([65535])),
        "array_4095": (KIND_ARRAY, _words(_pick(rng, 4095))),
        "array_4096": (KIND_ARRAY, _words(_pick(rng, 4096))),
        "dense": (KIND_BITMAP,
                  _words(np.unique(rng.integers(0, 1 << 16, 30000)))),
        "run_to_65535": (KIND_RUN, _words(np.arange(60000, 1 << 16))),
        "all_ones": (KIND_RUN, np.full(ROW_WORDS, 0xFFFF, np.uint16)),
    }
    A, B, kinds = [], [], []
    for ka, wa in rows.values():
        for kb, wb in rows.values():
            A.append(wa)
            B.append(wb)
            kinds += [ka, kb]
    return np.stack(A), np.stack(B), np.asarray(kinds, np.int32)


def array_pairs(rng):
    """Every pair of the packed-array kernel's rows -> (A u16[P, 4096], B
    u16[P, 4096], cards i32[2P] interleaved (card_a, card_b)). One row
    holds values in its slots while its card is 0."""
    vals = {
        "card_0": np.zeros(0, np.int64),
        "one_0": np.array([0]),
        "one_65535": np.array([65535]),
        "small": np.unique(rng.integers(0, 1 << 16, 300)),
        "with_65535": np.unique(np.concatenate(
            [rng.integers(0, 1 << 16, 2000), [0, 65535]])),
        "card_4095": _pick(rng, 4095),
        "card_4096": _pick(rng, 4096),
        "low_half_4096": np.arange(0, 8192, 2),
    }
    rows = {}
    for name, v in vals.items():
        row = np.full(ROW_WORDS, 0xFFFF, np.uint16)
        row[:v.size] = v
        rows[name] = (v.size, row)
    held = np.sort(rng.choice(1 << 16, ROW_WORDS, replace=False))
    rows["card_0_holding_values"] = (0, held.astype(np.uint16))
    A, B, cards = [], [], []
    for ca, ra in rows.values():
        for cb, rb in rows.values():
            if cb == 0 and rb[0] != 0xFFFF:
                rb = np.full(ROW_WORDS, 0xFFFF, np.uint16)   # B stays padded
            A.append(ra)
            B.append(rb)
            cards += [ca, cb]
    return np.stack(A), np.stack(B), np.asarray(cards, np.int32)
