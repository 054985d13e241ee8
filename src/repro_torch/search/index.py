"""``PostingIndex`` — term -> Roaring posting rows in one stacked slab.

The whole vocabulary lives in ONE stacked ``RoaringSlab`` ``[n_rows, C]``
on one device over a 32-bit document universe (``C = ceil(n_docs / 2^16)``
chunk rows per term, shared key row ``arange(C)``). Row 0 is reserved as
the empty posting so queries over unknown terms resolve to well-formed
empties.

``shard(mesh)`` partitions the *term* axis over a dimension of a
``torch.distributed`` ``DeviceMesh`` (``distributed.sharding.
shard_postings``): each rank keeps a contiguous block of rows, padded with
empty rows so the axis always divides, and ``topk`` then scores each
rank's rows with one stacked launch and gathers the scores
(``topk_by_card_sharded``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core import py_roaring as pr
from repro_torch.core import torch_roaring as tr
from repro_torch.index import engine as _engine
from repro_torch.roaring.slab import RoaringSlab

__all__ = ["PostingIndex"]

EMPTY_ROW = 0          # reserved: the posting every unknown term maps to


def _chunks_for(n_docs: int) -> int:
    return max(1, -(-n_docs // tr.CHUNK_SIZE))


class PostingIndex:
    """Immutable inverted index: sorted term vocabulary over one stacked
    slab (row 0 reserved empty, then one posting row per term in sorted
    term order). ``mesh`` / ``axis`` are set on sharded instances, whose
    stack leaves are DTensors (``shard`` returns a new index; the host
    metadata is shared)."""

    def __init__(self, terms: Tuple[str, ...], stack: RoaringSlab,
                 n_docs: int, mesh=None, axis: str = "data"):
        self.terms = terms
        self.stack = stack
        self.n_docs = n_docs
        self.C = stack.C
        self.mesh = mesh
        self.axis = axis
        self._row = {t: EMPTY_ROW + 1 + i for i, t in enumerate(terms)}

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_postings(cls, postings: Dict[str, np.ndarray], n_docs: int, *,
                      device=None) -> "PostingIndex":
        """Raw ``term -> doc-id array`` postings -> index on ``device``
        (default: the card). Doc ids must lie in ``[0, n_docs)``; duplicates
        and ordering are normalized through the host oracle (best-of-three
        canonical containers)."""
        from repro_torch.store.store import _posting, _stack_bitmaps
        dev = _device.resolve(device)
        terms = tuple(sorted(postings))
        bitmaps = [pr.RoaringBitmap()]
        for t in terms:
            ids = np.unique(np.asarray(postings[t], np.int64))
            if ids.size and (ids[0] < 0 or ids[-1] >= n_docs):
                raise ValueError(
                    f"term {t!r} has doc ids outside [0, {n_docs})")
            bitmaps.append(_posting(ids))
        stack = _stack_bitmaps(bitmaps, n_docs, _chunks_for(n_docs), dev)
        return cls(terms, stack, n_docs)

    @classmethod
    def from_arrays(cls, terms: Sequence[str], arrays: Dict[str, np.ndarray],
                    n_docs: int, *, device=None) -> "PostingIndex":
        """Adopt another index's stacked slab leaves as they are: ``arrays``
        maps ``keys`` / ``kinds`` / ``cards`` / ``nruns`` / ``payload`` to
        numpy arrays of shape ``[1 + len(terms), C]`` (payload ``[..., 4096]``
        u16), row 0 the reserved empty posting and row ``1 + i`` term
        ``terms[i]`` (sorted). The bytes are carried over unchanged."""
        terms = tuple(terms)
        if list(terms) != sorted(terms):
            raise ValueError("terms must be sorted")
        stack = RoaringSlab.from_numpy(
            arrays["keys"], arrays["kinds"], arrays["cards"],
            arrays["nruns"], arrays["payload"], device=device)
        if stack.ndim != 2 or stack.n_slabs < 1 + len(terms):
            raise ValueError(f"stack of shape {tuple(stack.keys.shape)} "
                             f"cannot hold {len(terms)} terms")
        if stack.C != _chunks_for(n_docs):
            raise ValueError(f"C = {stack.C} does not cover {n_docs} docs")
        return cls(terms, stack, n_docs)

    @classmethod
    def from_store(cls, store, column: str, *, device=None) -> "PostingIndex":
        """Adopt a ``BitmapStore`` equality column as the vocabulary: each
        value ``v`` becomes term ``"{column}={v}"`` whose posting is the
        column's slot bitmap (a host round trip through ``slot_bitmap``;
        the store's slabs are not aliased). ``device`` defaults to the
        store's."""
        from repro_torch.store.store import EqColumn
        col = store.column(column)
        if not isinstance(col, EqColumn):
            raise TypeError(f"column {column!r} is not an EqColumn")
        postings = {
            f"{column}={v}": store.slot_bitmap(col.base_slot + i).to_array()
            for i, v in enumerate(col.values)}
        return cls.from_postings(
            postings, store.n_rows,
            device=store.device if device is None else device)

    # -- lookups --------------------------------------------------------------
    @property
    def n_terms(self) -> int:
        return len(self.terms)

    @property
    def n_rows(self) -> int:
        """Stack rows including the reserved empty row and shard padding."""
        return self.stack.n_slabs

    @property
    def device(self):
        return self.stack.device

    def row(self, t: str) -> int:
        """Stack row for a term; unknown terms resolve to the reserved
        empty row."""
        return self._row.get(t, EMPTY_ROW)

    def term_of(self, row: int) -> Optional[str]:
        """Inverse of ``row`` (None for the reserved and padding rows)."""
        i = row - (EMPTY_ROW + 1)
        return self.terms[i] if 0 <= i < len(self.terms) else None

    def posting(self, t: str) -> RoaringSlab:
        """The term's posting as a single slab (row view of the stack)."""
        return self.stack[self.row(t)]

    # -- sharding -------------------------------------------------------------
    def shard(self, mesh, axis: str = "data") -> "PostingIndex":
        """New index whose stack's term axis is sharded over the ``axis``
        dimension of ``mesh`` (a ``DeviceMesh``) — rows are padded with
        empty postings (key row preserved, kind 0) up to a multiple of the
        axis size so the partition always divides."""
        from repro_torch.distributed.sharding import mesh_sizes, shard_postings
        stack = self.stack
        pad = (-stack.n_slabs) % mesh_sizes(mesh)[axis]
        if pad:
            def padded(x):
                return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
            stack = RoaringSlab(
                keys=torch.cat([stack.keys,
                                stack.keys[:1].expand(pad, stack.C)]),
                kinds=padded(stack.kinds), cards=padded(stack.cards),
                nruns=padded(stack.nruns), payload=padded(stack.payload),
                C=stack.C)
        stack = shard_postings(stack, mesh, axis)
        return PostingIndex(self.terms, stack, self.n_docs, mesh=mesh,
                            axis=axis)

    # -- scoring + accounting -------------------------------------------------
    def topk(self, query: RoaringSlab, k: int):
        """Top-k terms by ``|posting ∩ query|``: one stacked dispatch launch
        over all rows (over each rank's rows, the scores gathered, when the
        index is sharded). Returns ``(scores i32[k], rows i32[k])``."""
        if self.mesh is not None:
            return _engine.topk_by_card_sharded(self.stack, query, k,
                                                self.mesh, axis=self.axis)
        return _engine.topk_by_card(self.stack, query, k)

    def launch_model(self, expr) -> dict:
        """Analytic launch accounting for one lowered query expression."""
        return _engine.launch_model(expr)

    def __repr__(self) -> str:
        return (f"PostingIndex(terms={self.n_terms}, docs={self.n_docs}, "
                f"C={self.C}, {self.device}"
                + (", sharded" if self.mesh is not None else "") + ")")
