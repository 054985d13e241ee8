"""Seeded inputs that hold the attention kernels to their plain versions.

Shared by the parity tests, the card's tests and ``chip_smoke.py``.

Paged decode: each case has four rows: a long one whose window starts
mid-page (``starts > 0``) and fills every page slot, a short one, an empty
one (``counts = 0``) and one whose window starts on a page boundary. Pages
that no row lists in its first ``counts`` entries hold NaN, and the padding
after ``counts`` points at them, so a kernel that reads past ``counts``
shows it.

Paged decode across splits (``paged_decode_split_case``): the kernel
splits a row's positions over blocks of ``DECODE_SPLIT`` positions at this
case's size (``kernel.decode_split`` picks its smallest split for a few
hundred positions per sequence), and the four rows sit on those
boundaries: a window that starts past the first split, a length that ends
one position into a split, ``counts = 0``, and ``starts >= lengths`` with
pages listed. The last two have no live position and must give zeros.

Paged decode with long splits (``paged_decode_ring_case``): the page
lists are wide enough (``max_pages``, from the caller) that the kernel
takes its longest split, ``RING_SPLIT`` positions, and each row has
hundreds to thousands of live positions, so every warp of a split block
walks many more tiles than its ring of copies holds: ring slots are
refilled, page ids are loaded across the wrap, and the online softmax
rescales inside a warp. One window starts mid-tile and crosses a split
boundary, one starts 5 positions before a boundary, one ends mid-tile in
the first split, one crosses the second boundary. Every entry after
``counts`` points at a NaN page, half a million dead positions and more.

Block-sparse flash: six q-block rows over six KV blocks of 128 (the
model's ``sparse_block``). Row 0 lists only block 2, which under the
causal mask lies wholly in its future, so it has no live score and must
give zeros (the reference's Pallas kernel gives the mean of V there;
ROADMAP queue 3); row 1 lists nothing (``counts = 0``); the others list
2-3 blocks, one of them out of order. Block 5 is listed by no row and
holds NaN, and every padding entry after ``counts`` points at it.
``sparse_flash_random_case`` draws longer causal lists at random, for the
bf16 tensor-core kernel at the training path's shapes.
"""

from __future__ import annotations

import numpy as np

# (G, D, page_size, softcap, KVH) of the card's check: one and two query
# heads per KV head, stablelm's and gemma2's head dims, two page sizes,
# softcap on and off; then the registry's other (G, D) pairs (llama4 5 /
# 128, dbrx 6 / 128, qwen2-vl 8 / 128, starcoder2 12 / 128, stablelm-3b 1 /
# 80: bf16 rows of 160 bytes, 10 vectors of 16) and two pairs for the
# tensor-core kernel's padding of the query heads to an mma's 16 rows (16 /
# 128: all of them real; 3 / 64: an odd G, over 3 KV heads, so a block of
# four KV heads has a warp past the last), each at both page sizes,
# softcap off at 16 and on at 8; 4 KV heads unless a pair says otherwise
REGISTRY_PAIRS = ((5, 128), (6, 128), (8, 128), (12, 128), (1, 80))
PADDING_PAIRS = ((16, 128), (3, 64, 3))
CHECK_GRID = tuple((G, D, page, softcap, 4) for G in (1, 2)
                   for D in (64, 256) for page in (8, 16)
                   for softcap in (None, 50.0)) + tuple(
    (G, D, page, softcap, kvh[0] if kvh else 4)
    for G, D, *kvh in REGISTRY_PAIRS + PADDING_PAIRS
    for page, softcap in ((16, None), (8, 50.0)))


# positions per split block that paged_decode.cu takes for the split case
DECODE_SPLIT = 64
# (G, D, page_size, softcap, KVH) of the long-split check, in bf16 and f32:
# each head dim of the tensor-core kernel (64 / 80: four KV heads a block,
# a warp each; 128: four warps a KV head) and gemma2-2b's 256 (the CUDA-core
# kernel), at registry group sizes
RING_GRID = ((1, 64, 16, None, 4), (1, 80, 8, 50.0, 4),
             (12, 128, 16, None, 4), (6, 128, 8, 50.0, 8),
             (2, 256, 16, 50.0, 4))
# the split paged_decode.cu takes for the long-split case (its longest)
RING_SPLIT = 2048


def paged_decode_case(rng: np.random.Generator, G: int, D: int, page: int,
                      *, KVH: int = 4, max_pages: int = 12,
                      lengths=None, starts=None) -> dict:
    """float32 q [B, KVH, G, D], pools [P, page, KVH, D] and int32 page
    lists / counts / lengths / starts, as numpy arrays; by default the four
    rows of the module docstring (B = 4)."""
    if lengths is None:
        lengths = [page * (max_pages - 1) + 3, page + 2, 0, 3 * page]
        starts = [2 * page + 1, 0, 0, page]
    lengths = np.asarray(lengths, np.int32)
    starts = np.asarray(starts, np.int32)
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


def paged_decode_split_case(rng: np.random.Generator, G: int, D: int,
                            page: int, *, KVH: int = 4) -> dict:
    """``paged_decode_case`` with rows across ``DECODE_SPLIT``-position
    splits (B = 4, 6 splits a row): the window starts 5 positions into the
    third split and the row fills all but 3 positions; a row ends one
    position into the fourth split; an empty row (``counts = 0``); a row
    whose window starts past its length (``starts >= lengths``, pages
    listed)."""
    n = DECODE_SPLIT
    max_pages = 6 * n // page
    return paged_decode_case(
        rng, G, D, page, KVH=KVH, max_pages=max_pages,
        lengths=[max_pages * page - 3, 3 * n + 1, 0, n + 36],
        starts=[2 * n + 5, 0, 0, 2 * n])


def ring_max_pages(rows: int, blocks: int, page: int) -> int:
    """Page entries a row of the long-split case, so that ``rows`` split
    blocks a split reach ``blocks`` blocks (``DECODE_BLOCKS_PER_SM`` x the
    SMs) at ``RING_SPLIT``-position splits, and the case's rows fit."""
    return max(-(-blocks // rows), 3) * RING_SPLIT // page


def paged_decode_ring_case(rng: np.random.Generator, G: int, D: int,
                           page: int, *, KVH: int = 4,
                           max_pages: int) -> dict:
    """``paged_decode_case`` with the rows of the module docstring's
    long-split layout (B = 4) over ``max_pages`` page entries a row, which
    must reach past ``2 * RING_SPLIT`` positions."""
    n = RING_SPLIT
    if max_pages * page < 2 * n + 1500:
        raise ValueError(f"{max_pages} pages of {page} do not reach the "
                         "case's rows")
    return paged_decode_case(
        rng, G, D, page, KVH=KVH, max_pages=max_pages,
        lengths=[n + 613, n + 700, 531, 2 * n + 1500],
        starts=[37, n - 5, 0, 2 * n - 300])


def no_live_position(c: dict) -> np.ndarray:
    """bool[B]: the rows of a paged decode case that must give zeros."""
    return (c["counts"] == 0) | (c["starts"] >= c["lengths"])


# (G, D, softcap, causal) of the card's check of the block-sparse flash
# kernel, each in bf16 and f32: one and two query heads per KV head,
# stablelm's, a middle and gemma2's head dims, softcap on and off, causal
# and not
FLASH_GRID = tuple((G, D, softcap, causal) for G in (1, 2)
                   for D in (64, 128, 256) for softcap in (None, 50.0)
                   for causal in (True, False))
# the registry's training pairs (G, D) beyond the grid, each causal, in bf16
# and f32: llama4 5 / 128, dbrx 6 / 128, qwen2-vl and jamba 8 / 128,
# starcoder2 12 / 128 (an even G above 2: several GQA pairs a KV head),
# stablelm-3b 1 / 80; softcap off and on in turn
FLASH_REGISTRY_GRID = tuple(
    (G, D, softcap, True) for (G, D), softcap in zip(
        REGISTRY_PAIRS, (None, 50.0, None, 50.0, None)))
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


def sparse_flash_random_case(rng: np.random.Generator, G: int, D: int,
                             S: int, *, B: int = 1, KVH: int = 2,
                             block: int = FLASH_BLOCK) -> dict:
    """float32 q [B, KVH * G, S, D], k / v [B, KVH, S, D] and random causal
    block lists: q-block row r lists a random subset of blocks 0..r in
    random order, and now and then one block after r (wholly in its
    future, so never read when causal); padding after ``counts`` repeats
    block 0."""
    n = S // block
    rows = []
    for r in range(n):
        ids = list(rng.permutation(r + 1)[:int(rng.integers(1, r + 2))])
        if r + 1 < n and rng.random() < 0.3:
            ids.insert(int(rng.integers(0, len(ids) + 1)),
                       int(rng.integers(r + 1, n)))
        rows.append(ids)
    kv_idx = np.zeros((n, max(map(len, rows))), np.int32)
    counts = np.asarray([len(ids) for ids in rows], np.int32)
    for r, ids in enumerate(rows):
        kv_idx[r, :len(ids)] = ids
    q = rng.standard_normal((B, KVH * G, S, D)).astype(np.float32)
    k = rng.standard_normal((B, KVH, S, D)).astype(np.float32)
    v = rng.standard_normal((B, KVH, S, D)).astype(np.float32)
    return {"q": q, "k": k, "v": v, "kv_idx": kv_idx, "counts": counts}
