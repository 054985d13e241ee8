"""Roaring-paged KV cache: the host-side page table.

The page pools themselves are tensors ``[n_superblocks, P, page_size, KVH,
hd]`` per block kind (``models.transformer.init_paged_caches``). The
bookkeeping is the paper's machinery:

  * ``free``: a RoaringBitmap of free physical pages — allocation pops from
    it, release is a Roaring OR; fragmentation never hurts because the
    bitmap is the allocator;
  * per-sequence page lists stay *ordered* (logical order = list order);
  * ``gather_lists`` packs the page ids into the arrays the paged decode
    kernel reads.

The reference's device-side views of the table (``free_slab``,
``used_slab``, ``rebuild_free_slab``, ``shared_pages*``) and its ``audit``
wait for the slab operators and ``validate.py`` (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core.py_roaring import RoaringBitmap, union_many


class RoaringPageTable:
    """Host-side page allocator + per-sequence page lists."""

    def __init__(self, n_pages: int, page_size: int):
        self.n_pages = n_pages
        self.page_size = page_size
        # the free pool starts as one maximal run [0, n_pages) — a run
        # container, not a materialized page-id array
        self.free = RoaringBitmap.from_ranges([(0, n_pages)])
        self.seq_pages: Dict[int, List[int]] = {}
        self.seq_len: Dict[int, int] = {}

    def alloc(self, seq_id: int, n_tokens: int) -> List[int]:
        """Ensure capacity for n_tokens more tokens; returns new page ids."""
        cur = self.seq_len.get(seq_id, 0)
        pages = self.seq_pages.setdefault(seq_id, [])
        need = (cur + n_tokens + self.page_size - 1) // self.page_size
        new = []
        while len(pages) < need:
            if len(self.free) == 0:
                raise MemoryError("KV page pool exhausted")
            p = self.free.select(0)            # paper S2 select: first free
            self.free.remove(p)
            pages.append(p)
            new.append(p)
        self.seq_len[seq_id] = cur + n_tokens
        return new

    def release(self, seq_id: int) -> None:
        """Return a sequence's pages to the pool (Roaring OR)."""
        pages = self.seq_pages.pop(seq_id, [])
        self.seq_len.pop(seq_id, None)
        if pages:
            self.free.ior(RoaringBitmap.from_array(pages))

    def used_bitmap(self) -> RoaringBitmap:
        """All pages in use = many-way union (Alg. 4) of per-seq sets."""
        sets = [RoaringBitmap.from_array(p) for p in self.seq_pages.values()]
        if not sets:
            return RoaringBitmap()
        return union_many(sets)

    def utilization(self) -> float:
        return 1.0 - len(self.free) / self.n_pages

    def gather_lists(self, seq_ids: List[int], max_pages: int):
        """(page_idx i32[B, max_pages], counts i32[B], lengths i32[B])."""
        B = len(seq_ids)
        page_idx = np.zeros((B, max_pages), np.int32)
        counts = np.zeros((B,), np.int32)
        lengths = np.zeros((B,), np.int32)
        for i, s in enumerate(seq_ids):
            pages = self.seq_pages.get(s, [])
            assert len(pages) <= max_pages, (s, len(pages), max_pages)
            page_idx[i, : len(pages)] = pages
            counts[i] = len(pages)
            lengths[i] = self.seq_len.get(s, 0)
        return page_idx, counts, lengths
