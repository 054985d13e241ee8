"""Roaring-paged KV cache: the host-side page table.

The page pools themselves are tensors ``[n_superblocks, P, page_size, KVH,
hd]`` per block kind (``models.transformer.init_paged_caches``). The
bookkeeping is the paper's machinery:

  * ``free``: a RoaringBitmap of free physical pages — allocation pops from
    it, release is a Roaring OR; fragmentation never hurts because the
    bitmap is the allocator;
  * per-sequence page lists stay *ordered* (logical order = list order);
  * ``gather_lists`` packs the page ids into the arrays the paged decode
    kernel reads;
  * device-side views (``free_slab``, ``used_slab``, ``rebuild_free_slab``,
    ``shared_pages*``) put the page sets on the table's device as
    ``repro_torch.roaring`` slabs, and ``audit`` checks the allocator with
    ``repro_torch.roaring.validate``.

``PagedKVCache`` holds one pair of pools for all layers, ``[L, P, page,
KVH, hd]``, and scatters one token's K/V of every layer into them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch import _device

from repro_torch.core.py_roaring import RoaringBitmap, union_many


class RoaringPageTable:
    """Host-side page allocator + per-sequence page lists. The device views
    build their slabs on ``device`` (default: the card)."""

    def __init__(self, n_pages: int, page_size: int, device=None):
        self.n_pages = n_pages
        self.page_size = page_size
        self.device = device
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

    def audit(self):
        """Structural audit of the allocator (``roaring.validate``): the
        free/used partition exactly covers [0, n_pages) with no leaked,
        double-allocated, or duplicated pages, and per-sequence page counts
        cover ``seq_len``. Returns the machine-readable ``AuditReport``."""
        from repro_torch.roaring import validate as _v
        return _v.audit_page_table(self)

    # -- device-side views (repro_torch.roaring object API) -------------------
    def _page_capacity(self) -> int:
        from repro_torch import roaring
        return max(1, (self.n_pages + roaring.CHUNK_SIZE - 1)
                   // roaring.CHUNK_SIZE)

    def free_slab(self):
        """Free-page set as a device ``roaring.RoaringSlab`` — the free
        pool's run containers land as run rows directly."""
        from repro_torch.roaring import RoaringSlab
        return RoaringSlab.from_roaring(self.free, self._page_capacity(),
                                        device=self.device)

    def _seq_slab(self, pages):
        """One page list as a device slab (empty list -> empty slab)."""
        from repro_torch.roaring import RoaringSlab
        cap = self._page_capacity()
        if not pages:
            return RoaringSlab.empty(cap, device=self.device)
        return RoaringSlab.from_values(np.asarray(pages, np.int64), cap,
                                       len(pages), device=self.device)

    def _seq_slabs(self):
        """Per-sequence page sets as device slabs (skips empty sequences)."""
        return [self._seq_slab(p) for p in self.seq_pages.values() if p]

    def used_slab(self):
        """In-use pages as a device ``RoaringSlab`` — Alg. 4 as the engine's
        log-depth tree reduction over per-sequence page slabs, one deferred
        canonicalization (contiguous allocations union into run rows)."""
        from repro_torch import roaring
        cap = self._page_capacity()
        slabs = self._seq_slabs()
        if not slabs:
            return roaring.RoaringSlab.empty(cap, device=self.device)
        return roaring.union_all(slabs, capacity=cap)

    def rebuild_free_slab(self):
        """Recompute the free pool from scratch on the device: ``all_pages
        ANDNOT (∪ per-seq pages)`` through the expression executor, the
        operands attached as ``leaf(slab)`` nodes — a cross-check (and
        recovery rebuild) of the incrementally maintained host ``free``
        pool. Canonical output: a fresh pool comes back as run rows."""
        from repro_torch import index
        from repro_torch.roaring import RoaringSlab
        cap = self._page_capacity()
        full = RoaringSlab.from_ranges([(0, self.n_pages)], cap,
                                       device=self.device)
        slabs = self._seq_slabs()
        if not slabs:
            return full.run_optimize()
        expr = index.andnot(
            index.leaf(full),
            index.or_(*[index.leaf(s) for s in slabs]))
        return index.execute(expr, capacity=cap)

    def shared_pages_many(self, seq_id: int, others: List[int]) -> np.ndarray:
        """|pages(seq_id) ∩ pages(o)| for many candidate sequences in ONE
        stacked dispatch launch (i32[len(others)])."""
        from repro_torch import index, roaring
        if not others:
            return np.zeros((0,), np.int32)
        stack = roaring.stack(
            [self._seq_slab(self.seq_pages.get(o, [])) for o in others],
            capacity=self._page_capacity())
        return index.batched_and_card(
            stack, self._seq_slab(self.seq_pages.get(seq_id, []))
        ).cpu().numpy()

    def shared_pages(self, seq_a: int, seq_b: int) -> int:
        """# physical pages two sequences share, by the cardinality-only
        dispatch path (no result set materialized)."""
        from repro_torch.roaring import RoaringSlab
        cap = self._page_capacity()
        sa, sb = (RoaringSlab.from_values(
            np.asarray(self.seq_pages.get(s, []), np.int64), cap,
            self.n_pages, device=self.device) for s in (seq_a, seq_b))
        return int(sa.and_card(sb))

    # -- kernel metadata -------------------------------------------------------
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


@dataclasses.dataclass
class PagedKVCache:
    """Device-side page pools for all layers: [L, P, page, KVH, hd] x (k,
    v)."""

    k: torch.Tensor
    v: torch.Tensor
    page_size: int

    @classmethod
    def create(cls, n_layers: int, n_pages: int, page_size: int, kvh: int,
               hd: int, dtype=torch.bfloat16, *,
               device=None) -> "PagedKVCache":
        """Zeroed pools on ``device`` (``None``: the card)."""
        dev = _device.resolve(device)
        shape = (n_layers, n_pages, page_size, kvh, hd)
        return cls(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev), page_size)

    def write_token(self, layer_slices_k, layer_slices_v, page_ids,
                    offsets) -> "PagedKVCache":
        """Scatter one token's K/V ([L, B, KVH, hd]) of each of B sequences
        into (page_ids[b], offsets[b]) of every layer, **in place** on the
        pools' device (the reference returns a new cache), and return this
        cache."""
        dev = self.k.device
        pid = torch.as_tensor(page_ids).to(dev, torch.long)
        off = torch.as_tensor(offsets).to(dev, torch.long)
        self.k[:, pid, off] = torch.as_tensor(layer_slices_k).to(
            dev, self.k.dtype)
        self.v[:, pid, off] = torch.as_tensor(layer_slices_v).to(
            dev, self.v.dtype)
        return self
