"""Roaring block-mask algebra for sparse attention (host side).

An attention pattern over S tokens with block size B is an (S/B) x (S/B)
boolean matrix; each *query-block row* is an integer set of active key-block
ids, stored as a paper-faithful RoaringBitmap. Pattern primitives (local
window, global stripes, causal, document-boundary) are built as Roaring
bitmaps and composed with the paper's AND/OR/ANDNOT — this is the framework's
host-side mask compiler, running the actual reproduction code.

``compile_mask`` extracts every row's packed block list (Algorithm 2) into
the (kv_idx, counts) arrays the block-sparse flash kernel walks
(``kernels/sparse_attn/csrc/sparse_flash.cu``). For a 500k-token sequence
at block 128 there are 4096 block rows; each row's set lives in exactly one
Roaring container — arrays when sparse, bitmap containers when a row
attends broadly.

The device-side mask algebra (``union_many(device=True)``,
``rows_to_slabs``, ``mask_overlap_cards``, ``mask_jaccard``) runs the slab
engine of ``repro_torch.roaring`` on the card (or on ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.py_roaring import RoaringBitmap, union_many


def causal_mask(num_blocks: int) -> List[RoaringBitmap]:
    """Row r attends to blocks [0, r] — one run, built directly (2016
    paper's run containers; no per-block materialization)."""
    return [RoaringBitmap.from_range(0, r + 1) for r in range(num_blocks)]


def local_window_mask(num_blocks: int, window_blocks: int,
                      causal: bool = True) -> List[RoaringBitmap]:
    """Row r attends to its contiguous window — one run per row."""
    rows = []
    for r in range(num_blocks):
        lo = max(0, r - window_blocks + 1)
        hi = r + 1 if causal else min(num_blocks, r + window_blocks)
        rows.append(RoaringBitmap.from_range(lo, hi))
    return rows


def global_stripe_mask(num_blocks: int, stripe: Sequence[int],
                       causal: bool = True) -> List[RoaringBitmap]:
    """Every row attends to the given global block ids (and, symmetrically,
    stripe rows attend everywhere — the BigBird-style global pattern).
    Stripe rows are runs; scattered rows stay array containers."""
    stripe_arr = np.asarray(sorted(set(stripe)), dtype=np.int64)
    rows = []
    for r in range(num_blocks):
        s = stripe_arr[stripe_arr <= r] if causal else stripe_arr
        if r in stripe:
            rows.append(RoaringBitmap.from_range(
                0, r + 1 if causal else num_blocks))
        else:
            rb = RoaringBitmap.from_sorted_unique(s)
            rb.add(r)                      # always see own block
            rows.append(rb)
    return rows


def doc_boundary_mask(num_blocks: int, doc_starts_blocks: Sequence[int],
                      causal: bool = True) -> List[RoaringBitmap]:
    """Attention confined within document segments (from the data pipeline's
    bitmap index of document starts) — one run per row."""
    starts = sorted(set([0] + list(doc_starts_blocks)))
    bounds = starts + [num_blocks]
    rows = []
    for r in range(num_blocks):
        seg = max(i for i, s in enumerate(starts) if s <= r)
        lo, hi = bounds[seg], bounds[seg + 1]
        hi_eff = r + 1 if causal else hi
        rows.append(RoaringBitmap.from_range(lo, hi_eff))
    return rows


@dataclasses.dataclass
class MaskBuilder:
    """Composable mask: rows of RoaringBitmaps with paper set-algebra."""

    rows: List[RoaringBitmap]

    def union(self, other: "MaskBuilder") -> "MaskBuilder":
        return MaskBuilder([a | b for a, b in zip(self.rows, other.rows)])

    def union_many(self, others: Sequence["MaskBuilder"],
                   device=True,
                   capacity: Optional[int] = None) -> "MaskBuilder":
        """Alg. 4 union across many patterns, row-wise.

        ``device=False`` (or no ``others``) is the host heap union. Any
        other ``device`` routes through the batched slab engine: every
        builder's rows stack into one ``[R, capacity]`` slab on the card
        (``device=True``) or on the device named (``device="cpu"``), and
        ``roaring.union_all`` reduces them, one tree reduction per mask
        row; the two paths are bit-identical.
        """
        if not device or not others:
            return MaskBuilder([
                union_many([self.rows[i]] + [o.rows[i] for o in others])
                for i in range(len(self.rows))])
        from repro_torch import roaring

        if capacity is None:
            capacity = 1 + max(
                (r.keys[-1] for b in (self, *others) for r in b.rows
                 if r.keys), default=0)
        on = None if device is True else device
        stacks = [rows_to_slabs(b.rows, capacity, device=on)
                  for b in (self, *others)]
        merged = roaring.union_all(stacks, capacity=capacity)
        return MaskBuilder([merged[r].to_roaring()
                            for r in range(len(self.rows))])

    def intersect(self, other: "MaskBuilder") -> "MaskBuilder":
        return MaskBuilder([a & b for a, b in zip(self.rows, other.rows)])

    def subtract(self, other: "MaskBuilder") -> "MaskBuilder":
        return MaskBuilder([a.andnot(b) for a, b in zip(self.rows, other.rows)])

    def density(self) -> float:
        n = len(self.rows)
        return sum(len(r) for r in self.rows) / float(n * n)

    def size_in_bytes(self) -> int:
        """Compressed mask footprint — the paper's metric, applied to masks."""
        return sum(r.size_in_bytes() for r in self.rows)


def compile_mask(builder: MaskBuilder, max_active: Optional[int] = None):
    """Extract packed block lists: (kv_idx i32[R, max_active], counts i32[R]).

    Row extraction is Algorithm 2 on each row's containers. ``max_active``
    defaults to the longest row (the kernel grid's K dimension).
    """
    rows = builder.rows
    counts = np.asarray([len(r) for r in rows], np.int32)
    if max_active is None:
        max_active = max(1, int(counts.max()))
    kv_idx = np.zeros((len(rows), max_active), np.int32)
    for i, r in enumerate(rows):
        vals = r.to_array()
        if vals.size > max_active:
            raise ValueError(f"row {i} lists {vals.size} blocks, more than "
                             f"max_active = {max_active}")
        kv_idx[i, : vals.size] = vals
    return kv_idx, counts


def mask_density(kv_idx: np.ndarray, counts: np.ndarray) -> float:
    return float(counts.sum()) / (kv_idx.shape[0] ** 2)


# =============================================================================
# device-side mask algebra (the slab engine)
# =============================================================================

def rows_to_slabs(rows: Sequence[RoaringBitmap], capacity: int = 2, *,
                  device=None):
    """Stack mask rows into a batched ``roaring.RoaringSlab`` on ``device``
    (default: the card; leading axis = mask row).

    Block-id universes are small, so each row is one container; the
    kind-preserving bridge keeps window / causal / doc rows as run rows.
    Rows are stacked raw (``align=False``): elementwise-batched ops
    re-align per row.
    """
    from repro_torch import roaring

    return roaring.stack(
        [roaring.RoaringSlab.from_roaring(r, capacity, device=device)
         for r in rows], align=False)


def mask_overlap_cards(m1: "MaskBuilder", m2: "MaskBuilder",
                       capacity: int = 2, *, device=None) -> np.ndarray:
    """Per-row |row1 ∩ row2| without materializing intersection masks — the
    cardinality-only dispatch path, batched over rows (i32[R])."""
    s1 = rows_to_slabs(m1.rows, capacity, device=device)
    s2 = rows_to_slabs(m2.rows, capacity, device=device)
    return s1.and_card(s2).cpu().numpy().astype(np.int32)


def mask_jaccard(m1: "MaskBuilder", m2: "MaskBuilder",
                 capacity: int = 2, *, device=None) -> np.ndarray:
    """Per-row Jaccard similarity of two mask patterns (f32[R])."""
    s1 = rows_to_slabs(m1.rows, capacity, device=device)
    s2 = rows_to_slabs(m2.rows, capacity, device=device)
    return s1.jaccard(s2).cpu().numpy()


def build_arch_mask(num_blocks: int, *, pattern: str, window_blocks: int = 8,
                    n_global: int = 4, causal: bool = True) -> MaskBuilder:
    """Standard long-context pattern: local window UNION global stripes —
    composed with the paper's set algebra."""
    local = MaskBuilder(local_window_mask(num_blocks, window_blocks, causal))
    if pattern == "local":
        return local
    stripe = list(range(n_global))
    glob = MaskBuilder(global_stripe_mask(num_blocks, stripe, causal))
    if pattern == "local_global":
        return local.union(glob)
    raise ValueError(pattern)
