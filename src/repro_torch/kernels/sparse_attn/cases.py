"""Seeded inputs that hold the paged-decode kernel to its plain version.

Shared by the parity tests, the card's tests and ``chip_smoke.py``. Each
case has four rows: a long one whose window starts mid-page (``starts >
0``) and fills every page slot, a short one, an empty one (``counts = 0``)
and one whose window starts on a page boundary. Pages that no row lists in
its first ``counts`` entries hold NaN, and the padding after ``counts``
points at them, so a kernel that reads past ``counts`` shows it.
"""

from __future__ import annotations

import numpy as np

# (G, D, page_size, softcap) of the card's check: one and two query heads
# per KV head, stablelm's and gemma2's head dims, two page sizes, softcap
# on and off
CHECK_GRID = tuple((G, D, page, softcap) for G in (1, 2) for D in (64, 256)
                   for page in (8, 16) for softcap in (None, 50.0))


def paged_decode_case(rng: np.random.Generator, G: int, D: int, page: int,
                      *, KVH: int = 4, max_pages: int = 12) -> dict:
    """float32 q [4, KVH, G, D], pools [P, page, KVH, D] and int32 page
    lists / counts / lengths / starts, as numpy arrays."""
    lengths = np.asarray([page * (max_pages - 1) + 3, page + 2, 0, 3 * page],
                         np.int32)
    starts = np.asarray([2 * page + 1, 0, 0, page], np.int32)
    counts = (-(-lengths // page)).astype(np.int32)
    B, n_nan = len(lengths), 3
    P = int(counts.sum()) + n_nan
    perm = rng.permutation(P).astype(np.int32)
    nan_pages = perm[P - n_nan:]
    page_idx = np.zeros((B, max_pages), np.int32)
    used = 0
    for b in range(B):
        page_idx[b, :counts[b]] = perm[used:used + counts[b]]
        page_idx[b, counts[b]:] = nan_pages[b % n_nan]
        used += counts[b]
    q = rng.standard_normal((B, KVH, G, D)).astype(np.float32)
    k_pages = rng.standard_normal((P, page, KVH, D)).astype(np.float32)
    v_pages = rng.standard_normal((P, page, KVH, D)).astype(np.float32)
    k_pages[nan_pages] = np.nan
    v_pages[nan_pages] = np.nan
    return {"q": q, "k_pages": k_pages, "v_pages": v_pages,
            "page_idx": page_idx, "counts": counts, "lengths": lengths,
            "starts": starts}
