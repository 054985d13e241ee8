"""Seeded inputs that hold the attention kernels to their plain versions.

Shared by the parity tests, the card's tests and ``chip_smoke.py``.

Paged decode: each case has four rows: a long one whose window starts
mid-page (``starts > 0``) and fills every page slot, a short one, an empty
one (``counts = 0``) and one whose window starts on a page boundary. Pages
that no row lists in its first ``counts`` entries hold NaN, and the padding
after ``counts`` points at them, so a kernel that reads past ``counts``
shows it.

Block-sparse flash: six q-block rows over six KV blocks of 128 (the
model's ``sparse_block``). Row 0 lists only block 2, which under the
causal mask lies wholly in its future, so it has no live score and must
give zeros (the reference's Pallas kernel gives the mean of V there;
ROADMAP queue 3); row 1 lists nothing (``counts = 0``); the others list
2-3 blocks, one of them out of order. Block 5 is listed by no row and
holds NaN, and every padding entry after ``counts`` points at it.
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


# (G, D, softcap, causal) of the card's check of the block-sparse flash
# kernel, each in bf16 and f32: one and two query heads per KV head,
# stablelm's, a middle and gemma2's head dims, softcap on and off, causal
# and not
FLASH_GRID = tuple((G, D, softcap, causal) for G in (1, 2)
                   for D in (64, 128, 256) for softcap in (None, 50.0)
                   for causal in (True, False))
FLASH_BLOCK = 128
FLASH_LISTS = ((2,), (), (0, 1, 2), (3, 1), (4, 2), (4, 0, 3))
FLASH_NAN_BLOCK = 5


def sparse_flash_case(rng: np.random.Generator, G: int, D: int, *,
                      B: int = 2, KVH: int = 2, nan: bool = True) -> dict:
    """float32 q [B, KVH * G, S, D], k / v [B, KVH, S, D] (S = 768) and
    int32 kv_idx [6, 4] / counts [6], as numpy arrays; with ``nan``, the
    unlisted block 5 of k and v holds NaN."""
    n_blocks, max_active = len(FLASH_LISTS), 4
    S = n_blocks * FLASH_BLOCK
    kv_idx = np.full((n_blocks, max_active), FLASH_NAN_BLOCK, np.int32)
    counts = np.zeros((n_blocks,), np.int32)
    for r, ids in enumerate(FLASH_LISTS):
        kv_idx[r, :len(ids)] = ids
        counts[r] = len(ids)
    q = rng.standard_normal((B, KVH * G, S, D)).astype(np.float32)
    k = rng.standard_normal((B, KVH, S, D)).astype(np.float32)
    v = rng.standard_normal((B, KVH, S, D)).astype(np.float32)
    if nan:
        blk = slice(FLASH_NAN_BLOCK * FLASH_BLOCK,
                    (FLASH_NAN_BLOCK + 1) * FLASH_BLOCK)
        k[:, :, blk] = np.nan
        v[:, :, blk] = np.nan
    return {"q": q, "k": k, "v": v, "kv_idx": kv_idx, "counts": counts}
