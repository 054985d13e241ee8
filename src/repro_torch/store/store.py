"""``BitmapStore`` — the paper's database scenario as a real store layer.

The 2014 paper's headline numbers (Table 3 / Figure 2) come from *bitmap
indexes*: per-column, per-value bitmaps over a table's rows, combined with
Boolean algebra to answer predicate queries. This module is that store:

  * **Equality columns** ingest to one posting slab per distinct value —
    the bitmap of row ids where ``column == value`` (the classic bitmap
    index).
  * **Bit-sliced columns** (``bsi=...`` at build time) ingest integer
    columns as one slab per *bit* of the value (O'Neil/Quass bit-sliced
    index) — ``b = max_value.bit_length()`` slabs answer any range or
    aggregate query, instead of one slab per distinct value.
  * All slabs — plus the row **universe** (slot 0) and a canonical **empty**
    slab (slot 1) — are ingested into ONE key-aligned stacked
    ``repro_torch.roaring.RoaringSlab``, so a compiled predicate is a
    ``repro_torch.index`` expression tree over stack members and every
    query runs through the fused executor (``execute(..., fused=True)``)
    and its degradation ladder unchanged.

Compilation is total: ``eq`` on an unseen value compiles to the empty slab,
``not_`` compiles to ``ANDNOT`` against the universe, ``range_`` on a
bit-sliced column compiles to the slice-comparison tree (``v <= K`` as the
MSB-down prefix walk), and ``range_`` on an integer-valued equality column
compiles to an OR over the stored values inside the bounds. The result is
bit-identical — values, cardinality, kinds, serialized bytes — to filtering
the raw records row by row, and to the reference package's store.

Durability: ``save()`` emits every column slab through the portable
``RoaringFormatSpec`` codec (each blob is a standard Roaring interchange
stream a CRoaring/PyRoaring client can read) inside a small store container
format; ``load()`` treats the bytes as untrusted — see
``repro_torch.store.io``.

The port keeps the stacked slab on one device (``device=None``: the card,
raising without one; ``device="cpu"`` runs the plain versions). Where the
reference jits each query tree once, the port compiles it once: a cache of
``index.CompiledQuery`` plans (the lowered tree and, for ``fused=True``,
the ``FusedPlan`` and its operand order; the operand rows are gathered on
every call, so a plan holds no copy of the stack) keyed by ``(expr, fused,
backend)``, with the reference's hit / miss / fallback counters. Only an
injected fault (``InjectedFault``) that survives the engine's ladder takes
the ``store.fallback_eager`` path; a launch or build error propagates.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch import _device
from repro_torch import index as ix
from repro_torch.core import py_roaring as pr
from repro_torch.core import torch_roaring as jr
from repro_torch.roaring.slab import RoaringSlab
from repro_torch.runtime.fault_tolerance import InjectedFault
from repro_torch.store import predicate as P
from repro_torch.store.io import MAX_STACK_CELLS

__all__ = ["BitmapStore", "EqColumn", "BsiColumn",
           "UNIVERSE_SLOT", "EMPTY_SLOT"]

UNIVERSE_SLOT = 0          # all rows — the NOT / open-range operand
EMPTY_SLOT = 1             # no rows — the unseen-value / empty-IN operand
_RESERVED_SLOTS = 2


@dataclasses.dataclass(frozen=True)
class EqColumn:
    """An equality column: one posting slab per distinct value.

    ``values`` is the sorted tuple of distinct values (all int or all str —
    ``vkind`` names which); value ``values[i]`` lives at stack slot
    ``base_slot + i``.
    """

    name: str
    vkind: str                       # "int" | "str"
    values: Tuple
    base_slot: int

    @property
    def n_slabs(self) -> int:
        return len(self.values)


@dataclasses.dataclass(frozen=True)
class BsiColumn:
    """A bit-sliced integer column: slab ``base_slot + j`` holds the rows
    whose value has bit ``j`` set (LSB first), ``j < bits``."""

    name: str
    bits: int
    base_slot: int

    @property
    def n_slabs(self) -> int:
        return self.bits


def _chunks_for(n_rows: int) -> int:
    return max(1, -(-n_rows // jr.CHUNK_SIZE))


def _posting(row_ids: np.ndarray) -> pr.RoaringBitmap:
    """Sorted row ids -> best-of-three canonical host bitmap (canonical
    kinds are what make stored bytes match the engine's query outputs)."""
    return pr.RoaringBitmap.from_sorted_unique(
        np.asarray(row_ids, np.int64)).run_optimize()


def _pack_bitmaps(bitmaps: Sequence[pr.RoaringBitmap], n_rows: int,
                  n_chunks: int) -> tuple:
    """Host bitmaps -> the host arrays of ONE stacked slab aligned to the
    row universe's chunk keys (every posting is a subset of ``[0,
    n_rows)``, so the shared key row is ``arange(n_chunks)``): ``(keys,
    kinds, cards, nruns, payload)`` as ``RoaringSlab.from_numpy`` takes
    them."""
    N = len(bitmaps)
    kinds = np.zeros((N, n_chunks), np.int32)
    cards = np.zeros((N, n_chunks), np.int32)
    nruns = np.zeros((N, n_chunks), np.int32)
    payload = np.zeros((N, n_chunks, jr.ROW_WORDS), np.uint16)
    for s, rb in enumerate(bitmaps):
        for k, c in zip(rb.keys, rb.containers):
            cards[s, k] = c.cardinality
            if isinstance(c, pr.RunContainer):
                kinds[s, k] = jr.KIND_RUN
                nruns[s, k] = c.n_runs
                row = payload[s, k]
                row[:] = 0xFFFF
                row[0:2 * c.n_runs:2] = c.starts.astype(np.uint16)
                row[1:2 * c.n_runs:2] = c.lengths.astype(np.uint16)
            elif isinstance(c, pr.BitmapContainer):
                kinds[s, k] = jr.KIND_BITMAP
                payload[s, k] = c.words.view(np.uint16)
            else:
                kinds[s, k] = jr.KIND_ARRAY
                row = payload[s, k]
                row[:] = 0xFFFF
                row[: c.arr.size] = c.arr
    if n_rows > 0:
        keys_row = np.arange(n_chunks, dtype=np.int32)
    else:
        keys_row = np.full((n_chunks,), jr.KEY_SENTINEL, np.int32)
    keys = np.broadcast_to(keys_row, (N, n_chunks))
    return keys, kinds, cards, nruns, payload


def _stack_bitmaps(bitmaps: Sequence[pr.RoaringBitmap], n_rows: int,
                   n_chunks: int, device) -> RoaringSlab:
    """Host bitmaps -> ONE stacked ``RoaringSlab`` on ``device`` (see
    ``_pack_bitmaps``)."""
    return RoaringSlab.from_numpy(*_pack_bitmaps(bitmaps, n_rows, n_chunks),
                                  device=device)


def _sort_key(arr: np.ndarray) -> np.ndarray:
    """A key that sorts like ``arr``: int values that span fewer than 2^16
    become u16 offsets, which numpy's stable sort orders by radix."""
    if arr.dtype.kind == "i" and arr.size:
        lo = int(arr.min())
        if int(arr.max()) - lo < 1 << 16:
            return (arr - lo).astype(np.uint16)
    return arr


def _norm_column(name: str, col: np.ndarray):
    """Column array -> (vkind, normalized values). Ints (any numpy integer
    dtype or bool) and strings are supported; anything else is rejected at
    ingest, not discovered at query time."""
    arr = np.asarray(col)
    if arr.ndim != 1:
        raise ValueError(f"column {name!r} must be 1-D, got shape "
                         f"{arr.shape}")
    if arr.dtype.kind in "iub":
        return "int", arr.astype(np.int64)
    if arr.dtype.kind in "US":
        return "str", arr.astype(str)
    if arr.dtype.kind == "O":
        kinds = {type(v) for v in arr.tolist()}
        if kinds <= {int, bool}:
            return "int", arr.astype(np.int64)
        if kinds == {str}:
            return "str", arr.astype(str)
        raise TypeError(f"column {name!r} mixes value types {sorted(k.__name__ for k in kinds)}")
    raise TypeError(f"column {name!r} has unsupported dtype {arr.dtype} "
                    "(store columns hold ints or strings)")


class BitmapStore:
    """Per-(column, value) Roaring bitmap index over columnar records."""

    def __init__(self, n_rows: int, columns: Sequence, bitmaps: Sequence, *,
                 device=None, stack: Optional[RoaringSlab] = None):
        """Internal constructor — use ``build`` (from records) or ``load``
        (from a saved stream). ``bitmaps`` is the full slot-ordered list,
        including the universe and empty slots; the stacked slab goes to
        ``device`` (default: the card), or is ``stack`` when the caller
        stacked them already."""
        device = _device.resolve(device)
        self.n_rows = int(n_rows)
        self.columns: Tuple = tuple(columns)
        self._bitmaps: List[pr.RoaringBitmap] = list(bitmaps)
        self._by_name: Dict[str, object] = {c.name: c for c in self.columns}
        self._eq_slot: Dict[Tuple[str, object], int] = {}
        for c in self.columns:
            if isinstance(c, EqColumn):
                for i, v in enumerate(c.values):
                    self._eq_slot[(c.name, v)] = c.base_slot + i
        self.n_chunks = _chunks_for(self.n_rows)
        self._stack = stack if stack is not None else _stack_bitmaps(
            self._bitmaps, self.n_rows, self.n_chunks, device)
        # compiled plans per (expr, fused, backend): the lowered tree and,
        # fused, the FusedPlan with its operand order, no operand rows
        # (expression dataclasses are frozen, so they hash as cache keys)
        self._plans: Dict[Tuple, ix.CompiledQuery] = {}
        self._cache_hits = 0       # key already held a compiled plan
        self._cache_misses = 0     # cold compile: new plan lowered
        self._cache_fallbacks = 0  # injected fault -> uncompiled ladder

    # -- construction ---------------------------------------------------------
    @classmethod
    def build(cls, records: Dict[str, np.ndarray], *,
              bsi: Sequence[str] = (), device=None) -> "BitmapStore":
        """Ingest columnar ``records`` (name -> equal-length 1-D arrays)
        into a store on ``device`` (default: the card).

        Columns named in ``bsi`` must be non-negative integers and become
        bit-sliced-index columns (``range_`` / ``eq`` / ``in_`` / ``sum_``
        via slice algebra); every other column becomes an equality column
        with one posting slab per distinct value. The build adds its
        seconds to ``store.build_s{phase=...}``: ``postings`` (the sorts
        and host bitmaps), ``pack`` (the stacked slab's host arrays) and
        ``copy`` (their copy to ``device``, synchronised).
        """
        t0 = time.perf_counter()
        device = _device.resolve(device)
        if not records:
            raise ValueError("build needs at least one column")
        bsi = set(bsi)
        unknown = bsi - set(records)
        if unknown:
            raise ValueError(f"bsi names not in records: {sorted(unknown)}")
        lengths = {name: len(np.asarray(col)) for name, col in records.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"column lengths differ: {lengths}")
        n_rows = next(iter(lengths.values()))

        universe = pr.RoaringBitmap.from_ranges([(0, n_rows)]) if n_rows \
            else pr.RoaringBitmap()
        bitmaps: List[pr.RoaringBitmap] = [universe, pr.RoaringBitmap()]
        columns: List = []
        for name, col in records.items():
            vkind, arr = _norm_column(name, col)
            if name in bsi:
                if vkind != "int":
                    raise TypeError(f"bsi column {name!r} must be integer")
                if n_rows and int(arr.min()) < 0:
                    raise ValueError(f"bsi column {name!r} holds negative "
                                     "values")
                bits = max(1, int(arr.max()).bit_length()) if n_rows else 1
                columns.append(BsiColumn(name, bits, len(bitmaps)))
                for j in range(bits):
                    rows = np.nonzero((arr >> j) & 1)[0]
                    bitmaps.append(_posting(rows))
            else:
                # stable argsort groups equal values with ascending row ids
                # (as 16-bit keys when the values span < 2^16: a radix sort)
                order = np.argsort(_sort_key(arr), kind="stable")
                svals = arr[order]
                if n_rows:
                    bounds = np.nonzero(svals[1:] != svals[:-1])[0] + 1
                    starts = np.concatenate(([0], bounds))
                    ends = np.concatenate((bounds, [n_rows]))
                else:
                    starts = ends = np.empty(0, np.int64)
                values = []
                base = len(bitmaps)
                for s, e in zip(starts.tolist(), ends.tolist()):
                    v = svals[s]
                    values.append(int(v) if vkind == "int" else str(v))
                    bitmaps.append(_posting(order[s:e]))
                columns.append(EqColumn(name, vkind, tuple(values), base))
        t1 = time.perf_counter()
        packed = _pack_bitmaps(bitmaps, n_rows, _chunks_for(n_rows))
        t2 = time.perf_counter()
        stack = RoaringSlab.from_numpy(*packed, device=device)
        if stack.device.type == "cuda":
            torch.cuda.synchronize(stack.device)
        t3 = time.perf_counter()
        reg = obs.registry()
        reg.counter("store.build_s", phase="postings").inc(t1 - t0)
        reg.counter("store.build_s", phase="pack").inc(t2 - t1)
        reg.counter("store.build_s", phase="copy").inc(t3 - t2)
        return cls(n_rows, columns, bitmaps, device=device, stack=stack)

    # -- persistence ----------------------------------------------------------
    def save(self) -> bytes:
        """Store -> durable byte stream (``repro_torch.store.io`` container
        format; every slab is a portable ``RoaringFormatSpec`` blob)."""
        from repro_torch.store import io as _io
        return _io.save_store(self)

    @classmethod
    def load(cls, data: bytes, *, limits=None, check: bool = False,
             max_stack_cells: int = MAX_STACK_CELLS,
             device=None) -> "BitmapStore":
        """Untrusted byte stream -> store on ``device`` (typed rejection on
        any structural violation; see ``repro_torch.store.io.load_store``,
        whose slabs x chunks cap ``max_stack_cells`` raises)."""
        from repro_torch.store import io as _io
        return _io.load_store(data, limits=limits, check=check,
                              max_stack_cells=max_stack_cells, device=device)

    # -- schema introspection --------------------------------------------------
    def column(self, name: str):
        """The ``EqColumn`` / ``BsiColumn`` schema entry for ``name``."""
        try:
            return self._by_name[name]
        except KeyError:
            raise KeyError(f"no column {name!r}; store has "
                           f"{sorted(self._by_name)}") from None

    @property
    def device(self) -> torch.device:
        """Where the stacked slab lives."""
        return self._stack.device

    @property
    def n_slabs(self) -> int:
        """Total stacked slabs (columns + the universe and empty slots)."""
        return len(self._bitmaps)

    def index_size_in_bytes(self) -> int:
        """Serialized size of the column slabs (the paper's index-size
        metric; the derivable universe/empty slots are excluded)."""
        return sum(rb.size_in_bytes()
                   for rb in self._bitmaps[_RESERVED_SLOTS:])

    def slot_bitmap(self, slot: int) -> pr.RoaringBitmap:
        """Host bitmap at a stack slot (interop/debug surface)."""
        return self._bitmaps[slot]

    # -- predicate compilation -------------------------------------------------
    def compile(self, pred: P.Pred) -> ix.Expr:
        """Predicate -> ``repro_torch.index`` expression tree over the store's
        stacked slabs. Total: every well-typed predicate compiles, with
        unseen values landing on the empty slab."""
        if isinstance(pred, P.Eq):
            return self._compile_eq(pred.col, pred.value)
        if isinstance(pred, P.In):
            if not pred.values:
                return ix.leaf(EMPTY_SLOT)
            return ix.or_(*[self._compile_eq(pred.col, v)
                            for v in dict.fromkeys(pred.values)])
        if isinstance(pred, P.Range):
            return self._compile_range(pred.col, pred.lo, pred.hi)
        if isinstance(pred, P.AndP):
            return ix.and_(*[self.compile(c) for c in pred.children])
        if isinstance(pred, P.OrP):
            return ix.or_(*[self.compile(c) for c in pred.children])
        if isinstance(pred, P.NotP):
            return ix.andnot(ix.leaf(UNIVERSE_SLOT), self.compile(pred.child))
        raise TypeError(f"not a store predicate: {pred!r}")

    def _compile_eq(self, name: str, value) -> ix.Expr:
        col = self.column(name)
        if isinstance(col, EqColumn):
            if isinstance(value, str) != (col.vkind == "str"):
                raise TypeError(f"column {name!r} holds {col.vkind} values, "
                                f"predicate names {value!r}")
            slot = self._eq_slot.get((name, value))
            return ix.leaf(EMPTY_SLOT if slot is None else slot)
        v = int(value)
        if v < 0 or v >= (1 << col.bits):
            return ix.leaf(EMPTY_SLOT)
        # AND over all slices: bit set -> slice, bit clear -> NOT slice
        terms = [ix.leaf(col.base_slot + j) if (v >> j) & 1
                 else self._not(ix.leaf(col.base_slot + j))
                 for j in range(col.bits)]
        return ix.and_(*terms)

    def _compile_range(self, name: str, lo: Optional[int],
                       hi: Optional[int]) -> ix.Expr:
        col = self.column(name)
        if isinstance(col, EqColumn):
            if col.vkind != "int":
                raise TypeError(f"range_ over column {name!r} needs integer "
                                "values, column holds strings")
            hits = [col.base_slot + i for i, v in enumerate(col.values)
                    if (lo is None or v >= lo) and (hi is None or v <= hi)]
            if not hits:
                return ix.leaf(EMPTY_SLOT)
            return ix.or_(*[ix.leaf(s) for s in hits])
        # bit-sliced: [lo, hi] == LE(hi) ANDNOT LE(lo - 1)
        upper = self._bsi_le(col, hi) if hi is not None else \
            ix.leaf(UNIVERSE_SLOT)
        if lo is None or lo <= 0:
            return upper
        return ix.andnot(upper, self._bsi_le(col, lo - 1))

    def _bsi_le(self, col: BsiColumn, k: int) -> ix.Expr:
        """Rows with ``value <= k`` over the bit slices: the O'Neil/Quass
        MSB-down walk emitted as an expression tree — one OR of per-bit
        "strictly below at bit j" terms plus the all-bits-equal term, with
        the shared equality prefix reused as one sub-expression (the fused
        planner hash-conses it; the per-op path re-evaluates ``O(bits)``
        small combines)."""
        if k < 0:
            return ix.leaf(EMPTY_SLOT)
        if k >= (1 << col.bits) - 1:
            return ix.leaf(UNIVERSE_SLOT)
        below: List[ix.Expr] = []
        prefix: Optional[ix.Expr] = None      # "equal on all higher bits"
        for j in reversed(range(col.bits)):
            s_j = ix.leaf(col.base_slot + j)
            if (k >> j) & 1:
                term = self._not(s_j) if prefix is None else \
                    ix.and_(prefix, self._not(s_j))
                below.append(term)
                prefix = s_j if prefix is None else ix.and_(prefix, s_j)
            else:
                prefix = self._not(s_j) if prefix is None else \
                    ix.and_(prefix, self._not(s_j))
        return ix.or_(*below, prefix)

    @staticmethod
    def _not(e: ix.Expr) -> ix.Expr:
        return ix.andnot(ix.leaf(UNIVERSE_SLOT), e)

    # -- queries ---------------------------------------------------------------
    def cache_stats(self) -> dict:
        """Plan-cache accounting: ``hits`` (key already held a compiled
        plan), ``misses`` (cold compiles), ``fallbacks`` (an injected fault
        survived the compiled run's ladder and the query re-ran uncompiled —
        counted separately from cold compiles), ``entries``, and what the
        cache is keyed by."""
        return {"hits": self._cache_hits, "misses": self._cache_misses,
                "fallbacks": self._cache_fallbacks,
                "entries": len(self._plans),
                "keyed_by": "(expr, fused, backend)"}

    def _run_cached(self, key: Tuple, expr: ix.Expr, fused: bool,
                    run: Callable, eager_fn: Callable):
        """One cached-plan run: cache lookup (hit/miss accounting), the
        compiled run under a ``store.execute`` span, and the uncompiled
        ladder (its own span + counter) when an injected fault survives the
        compiled run's ladder. Any other error propagates."""
        plan = self._plans.get(key)
        if plan is None:
            self._cache_misses += 1
            cache = "miss"
            plan = ix.compile_query(self._stack, expr, fused=fused)
            self._plans[key] = plan
        else:
            self._cache_hits += 1
            cache = "hit"
        try:
            with obs.span("store.execute"):
                return run(plan)
        except InjectedFault:
            self._cache_fallbacks += 1
            with obs.span("store.fallback_eager"):
                return eager_fn()

    def query(self, pred: P.Pred, *, fused: bool = False,
              backend: Optional[str] = None, max_retries: int = 1,
              backoff_s: float = 0.0) -> RoaringSlab:
        """Rows matching ``pred`` as a canonical ``RoaringSlab`` of row ids —
        one ``index.execute`` run (``fused=True`` = one kernel launch for the
        whole tree) through the engine's degradation ladder.

        The tree is compiled once per (expr, fused, backend) and reused. An
        injected fault that survives the compiled run's ladder re-runs the
        query uncompiled with ``max_retries`` / ``backoff_s``. While spans
        record (``repro_torch.obs.enable()`` or a running
        ``torch.profiler``) the call leaves a ``store.query`` tree:
        ``store.compile``, ``store.execute`` and the engine's spans under it.
        """
        with obs.span("store.query"):
            with obs.span("store.compile"):
                expr = self.compile(pred)
            out = self._run_cached(
                (expr, fused, backend), expr, fused,
                lambda plan: ix.execute(self._stack, compiled=plan,
                                        fused=fused, backend=backend),
                lambda: ix.execute(self._stack, expr, fused=fused,
                                   backend=backend, max_retries=max_retries,
                                   backoff_s=backoff_s))
            return out

    def count(self, pred: P.Pred, *, fused: bool = False,
              backend: Optional[str] = None, max_retries: int = 1,
              backoff_s: float = 0.0) -> int:
        """|rows matching ``pred``| without materializing the result slab
        (the same plan cache and fallback as ``query``)."""
        with obs.span("store.count"):
            with obs.span("store.compile"):
                expr = self.compile(pred)
            out = self._run_cached(
                ("card", expr, fused, backend), expr, fused,
                lambda plan: ix.execute_card(self._stack, compiled=plan,
                                             fused=fused, backend=backend),
                lambda: ix.execute_card(self._stack, expr, fused=fused,
                                        backend=backend,
                                        max_retries=max_retries,
                                        backoff_s=backoff_s))
            with obs.span("device.wait"):
                return int(out)

    def query_indices(self, pred: P.Pred, **kw) -> np.ndarray:
        """Matching row ids as a sorted host ``int64`` array."""
        return self.query(pred, **kw).to_roaring().to_array()

    def sum_(self, name: str, pred: Optional[P.Pred] = None) -> int:
        """Sum of a bit-sliced column over the rows matching ``pred``
        (all rows when ``None``): Σ_j 2^j · |slice_j ∩ rows| — one batched
        scoring launch over the column's slices, nothing materialized per
        bit."""
        col = self.column(name)
        if not isinstance(col, BsiColumn):
            raise TypeError(f"sum_ needs a bit-sliced column; {name!r} is "
                            "an equality column")
        with obs.span("store.sum_"):
            rows = self.query(pred) if pred is not None else \
                ix.execute(self._stack, ix.leaf(UNIVERSE_SLOT))
            slots = torch.arange(col.base_slot, col.base_slot + col.bits,
                                 device=self._stack.device)
            scores = ix.batched_and_card(self._stack[slots], rows)
            with obs.span("device.wait"):
                per_bit = scores.cpu().numpy()
            weights = np.asarray([1 << j for j in range(col.bits)], np.int64)
            return int(per_bit.astype(np.int64) @ weights)

    def __repr__(self) -> str:
        parts = ", ".join(
            f"{c.name}:{'bsi' + str(c.bits) if isinstance(c, BsiColumn) else len(c.values)}"
            for c in self.columns)
        return (f"BitmapStore(n_rows={self.n_rows}, slabs={self.n_slabs}, "
                f"columns=[{parts}])")
