"""``SearchService`` — batched Boolean term queries over a ``PostingIndex``.

Three moving parts, each instrumented on the ``repro_torch.obs`` plane:

**Planning** (``search.plan`` span): a term query tree (``Term`` / ``And``
/ ``Or`` / ``AndNot``) lowers to a ``repro_torch.index`` expression whose
leaves are *positions* in the request's deduplicated term list. The lowered
expression is the request's structural signature: two requests batch
together exactly when their lowered expressions are equal.

**Hot-term cache** (``search.cache`` span): an LRU-managed resident cache
stack ``[cache_slots, C]`` on the index's device holds the hot vocabulary;
misses fill in ONE batched gather from the posting stack, padded to the
fixed width ``cache_slots`` against a scratch row; hits skip it. Hit /
miss / eviction counts land on ``search.cache.{hits,misses,evictions}``.

**Batched execution** (``search.execute`` span): a batch of B same-shape
requests packs into one pseudo-stacked slab — leaf ``i`` of every request
concatenates along the container axis into row ``[i, B*C]`` (keys
``tile(arange(C), B)``) — so the engine runs the whole batch as ONE
expression: one ``fused_tree`` launch (``fused=True``) or one per-op tree
reduce. Per-request results are the ``[B, C]`` unflattening, byte-identical
to evaluating each request alone. Execution runs under the engine's
degradation ladder. Per-request submit-to-completion latency lands in the
``search.latency_us`` log2 histogram.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.core import torch_roaring as tr
from repro_torch.index import engine as _engine
from repro_torch.kernels.roaring.dispatch import narrow
from repro_torch.roaring.slab import RoaringSlab
from repro_torch.search.index import PostingIndex

__all__ = ["Term", "And", "Or", "AndNot", "term", "and_", "or_", "andnot",
           "lower", "SearchService", "MODES"]

MODES = ("count", "docs", "topk")


# =============================================================================
# query trees (term-level; lowered to repro_torch.index expressions)
# =============================================================================

@dataclasses.dataclass(frozen=True)
class Query:
    """Base class for Boolean term-query trees (static structure)."""


@dataclasses.dataclass(frozen=True)
class Term(Query):
    """One vocabulary term; unknown terms match the empty posting."""

    term: str


@dataclasses.dataclass(frozen=True)
class And(Query):
    children: Tuple[Query, ...]


@dataclasses.dataclass(frozen=True)
class Or(Query):
    children: Tuple[Query, ...]


@dataclasses.dataclass(frozen=True)
class AndNot(Query):
    a: Query
    b: Query


def term(t: str) -> Term:
    return Term(t)


def and_(*children: Query) -> Query:
    if not children:
        raise ValueError("and_() needs at least one child")
    return children[0] if len(children) == 1 else And(tuple(children))


def or_(*children: Query) -> Query:
    if not children:
        raise ValueError("or_() needs at least one child")
    return children[0] if len(children) == 1 else Or(tuple(children))


def andnot(a: Query, b: Query) -> AndNot:
    return AndNot(a, b)


def lower(q: Query) -> Tuple[_engine.Expr, Tuple[str, ...]]:
    """Term tree -> (positional expression, deduplicated term list). A term
    referenced twice lowers to the same leaf position. The expression
    doubles as the batching signature."""
    terms: List[str] = []
    pos: Dict[str, int] = {}

    def visit(n: Query) -> _engine.Expr:
        if isinstance(n, Term):
            if n.term not in pos:
                pos[n.term] = len(terms)
                terms.append(n.term)
            return _engine.Leaf(pos[n.term])
        if isinstance(n, And):
            return _engine.and_(*[visit(c) for c in n.children])
        if isinstance(n, Or):
            return _engine.or_(*[visit(c) for c in n.children])
        if isinstance(n, AndNot):
            return _engine.andnot(visit(n.a), visit(n.b))
        raise TypeError(f"not a search Query: {n!r}")

    return visit(q), tuple(terms)


# =============================================================================
# the LRU hot-term slab cache
# =============================================================================

class _SlabCache:
    """Resident cache stack ``[slots, C]`` + LRU term -> slot map.

    ``ensure`` is the only mutator: hits refresh recency, misses allocate
    (evicting LRU-first) and fill in one batched gather from the posting
    stack."""

    def __init__(self, index: PostingIndex, slots: int):
        st = index.stack
        self.index = index
        self.slots = slots
        # one extra scratch row (index ``slots``): every fill pads its miss
        # list to the fixed width ``slots`` targeting it
        dev, C = index.device, index.C
        self.payload = torch.zeros((slots + 1, C, tr.ROW_WORDS),
                                   dtype=st.payload.dtype, device=dev)
        self.cards = torch.zeros((slots + 1, C), dtype=torch.int32,
                                 device=dev)
        self.kinds = torch.zeros_like(self.cards)
        self.nruns = torch.zeros_like(self.cards)
        self.lru: "collections.OrderedDict[str, int]" = \
            collections.OrderedDict()
        self._free = list(range(slots - 1, -1, -1))

    def ensure(self, terms: Sequence[str]) -> Dict[str, int]:
        """Make every term resident; return term -> cache slot. Hits move
        to MRU *before* any eviction, so a batch that fits can never evict
        its own members."""
        reg = obs.registry()
        hits = [t for t in terms if t in self.lru]
        misses = [t for t in terms if t not in self.lru]
        for t in hits:
            self.lru.move_to_end(t)
        if hits:
            reg.counter("search.cache.hits").inc(len(hits))
        if misses:
            reg.counter("search.cache.misses").inc(len(misses))
            alloc = []
            for t in misses:
                if self._free:
                    s = self._free.pop()
                else:
                    _, s = self.lru.popitem(last=False)       # evict LRU
                    reg.counter("search.cache.evictions").inc()
                alloc.append(s)
                self.lru[t] = s
            st = self.index.stack
            pad = self.slots - len(misses)
            dev = self.payload.device
            rows = torch.tensor([self.index.row(t) for t in misses]
                                + [0] * pad, dtype=torch.int64, device=dev)
            sl = torch.tensor(alloc + [self.slots] * pad, dtype=torch.int64,
                              device=dev)
            self.payload[sl] = st.payload[rows]
            self.cards[sl] = st.cards[rows]
            self.kinds[sl] = st.kinds[rows]
            self.nruns[sl] = st.nruns[rows]
        return {t: self.lru[t] for t in terms}

    def resident(self) -> Tuple[str, ...]:
        """Resident terms in LRU -> MRU order."""
        return tuple(self.lru)


# =============================================================================
# the service
# =============================================================================

@dataclasses.dataclass
class _Request:
    rid: int
    expr: _engine.Expr
    terms: Tuple[str, ...]
    mode: str
    k: int
    t_submit: float

    @property
    def gkey(self):
        return (self.expr, len(self.terms), self.mode, self.k)


class SearchService:
    """Batching query frontend over one ``PostingIndex``.

    ``mode`` per request: ``"count"`` -> int cardinality; ``"docs"`` ->
    sorted ``np.ndarray`` of matching doc ids; ``"topk"`` -> the k highest-
    scoring ``(term, |posting ∩ result|)`` pairs over the whole vocabulary.
    Everything runs on the index's device.
    """

    def __init__(self, index: PostingIndex, *, max_batch: int = 8,
                 cache_slots: int = 64, fused: bool = True,
                 backend: Optional[str] = None, max_retries: int = 1,
                 backoff_s: float = 0.0):
        if cache_slots < 1:
            raise ValueError("cache_slots must be >= 1")
        self.index = index
        self.max_batch = max_batch
        self.cache_slots = cache_slots
        self.fused = fused
        self.backend = backend
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.queue: List[_Request] = []
        self.steps_run = 0
        self.requeues = 0
        self._cache = _SlabCache(index, cache_slots)
        self._keys_row = torch.arange(index.C, dtype=torch.int32,
                                      device=index.device)
        self._results: Dict[int, object] = {}
        self._next_rid = 0

    # -- request lifecycle ----------------------------------------------------
    def submit(self, q: Query, mode: str = "count", k: int = 10) -> int:
        """Lower + enqueue one query; returns the request id."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        with obs.span("search.plan", mode=mode):
            expr, terms = lower(q)
        if len(terms) > self.cache_slots:
            raise ValueError(
                f"query has {len(terms)} distinct terms but the cache holds "
                f"{self.cache_slots} slots — it can never be admitted")
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(_Request(rid, expr, terms, mode,
                                   k if mode == "topk" else 0,
                                   time.perf_counter()))
        return rid

    def step(self) -> List[int]:
        """One service iteration: admit a same-signature batch, make its
        terms resident, execute it as one stacked launch. Returns the
        completed request ids."""
        batch = self._admit()
        if batch:
            batch_terms = []
            for r in batch:
                batch_terms.extend(t for t in r.terms
                                   if t not in batch_terms)
            with obs.span("search.cache", terms=len(batch_terms)):
                slot_of = self._cache.ensure(batch_terms)
            with obs.span("search.execute", batch=len(batch),
                          mode=batch[0].mode):
                self._execute(batch, slot_of)
        self.steps_run += 1
        if obs.enabled():
            obs.publish_service_gauges(
                "search", queue_depth=len(self.queue), active=len(batch),
                requeues=self.requeues, steps=self.steps_run,
                **{"cache.resident": len(self._cache.lru)})
        return [r.rid for r in batch]

    def run_until_done(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.queue:
                return
            self.step()
        raise RuntimeError(f"queue not drained after {max_steps} steps")

    def poll(self) -> Dict[int, object]:
        """All results completed since the last poll (drained)."""
        out, self._results = self._results, {}
        return out

    def take(self, rid: int):
        """Pop one completed request's result (KeyError when pending)."""
        return self._results.pop(rid)

    def search(self, q: Query, mode: str = "count", k: int = 10):
        """Synchronous single query: submit + drain + take."""
        rid = self.submit(q, mode, k)
        self.run_until_done()
        return self.take(rid)

    def search_many(self, queries: Sequence[Query], mode: str = "count",
                    k: int = 10) -> list:
        """Submit many queries, drain, return results in submit order."""
        rids = [self.submit(q, mode, k) for q in queries]
        self.run_until_done()
        return [self.take(r) for r in rids]

    def launch_model(self, q: Query) -> dict:
        """Analytic launch accounting for one request's lowered expression
        (B same-shape requests run the same launches ONCE over a B-times
        wider stack)."""
        expr, _ = lower(q)
        return self.index.launch_model(expr)

    def cache_stats(self) -> dict:
        reg = obs.registry()
        return {"hits": int(reg.value("search.cache.hits")),
                "misses": int(reg.value("search.cache.misses")),
                "evictions": int(reg.value("search.cache.evictions")),
                "resident": self._cache.resident()}

    # -- admission ------------------------------------------------------------
    def _admit(self) -> List[_Request]:
        """Greedy same-signature packing in FIFO order. Requests whose
        terms would overflow the cache defer to a later step (counted in
        ``requeues``); different-signature requests wait their turn."""
        if not self.queue:
            return []
        gkey = self.queue[0].gkey
        batch: List[_Request] = []
        remaining: List[_Request] = []
        terms: set = set()
        deferred = False
        for r in self.queue:
            if (deferred or r.gkey != gkey
                    or len(batch) >= self.max_batch):
                remaining.append(r)
                continue
            grown = terms | set(r.terms)
            if len(grown) > self.cache_slots:
                self.requeues += 1
                deferred = True
                remaining.append(r)
                continue
            batch.append(r)
            terms = grown
        self.queue = remaining
        return batch

    # -- execution ------------------------------------------------------------
    def _batch_fn(self, ev, expr: _engine.Expr, B: int, L: int,
                  want_rows: bool):
        """One batch evaluator: leaf ``i``'s rows for all B requests
        concatenate along the container axis (``[L, B*C]``; keys
        ``tile(arange(C), B)``), one engine evaluation covers the batch, and
        per-request results are the ``[B, C]`` unflattening."""
        C = self.index.C
        keys_flat = self._keys_row.repeat(B)
        c = self._cache

        def f(slots: torch.Tensor):
            idx = slots.t()                                # [L, B]

            def fl(x):
                y = x[idx]                                 # [L, B, C, ...]
                return y.reshape((L, B * C) + tuple(y.shape[3:]))

            flat = RoaringSlab(
                keys=keys_flat.expand(L, B * C), kinds=fl(c.kinds),
                cards=fl(c.cards), nruns=fl(c.nruns), payload=fl(c.payload),
                C=B * C)
            data, card, kind = ev(flat, keys_flat, expr)
            rc = card.reshape(B, C)
            if not want_rows:
                return rc.sum(dim=1, dtype=torch.int64)
            words = narrow(tr._lift_rows(data, card, kind))
            return rc, words.reshape(B, C, tr.ROW_WORDS)

        return f

    def _execute(self, batch: List[_Request], slot_of: Dict[str, int]):
        B, L = len(batch), len(batch[0].terms)
        mode, expr = batch[0].mode, batch[0].expr
        want_rows = mode != "count"
        fused_fn = self._batch_fn(_engine._fused_eval, expr, B, L, want_rows)
        per_op_fn = self._batch_fn(_engine._eval, expr, B, L, want_rows)
        slots = torch.tensor([[slot_of[t] for t in r.terms] for r in batch],
                             dtype=torch.int64, device=self.index.device)
        out = _engine._run_query(
            lambda: fused_fn(slots), lambda: per_op_fn(slots),
            self.fused, self.backend, self.max_retries, self.backoff_s,
            self.index.device)
        if mode == "count":
            counts = out.cpu().tolist()
            for i, r in enumerate(batch):
                self._finish(r, int(counts[i]))
            return
        rc, words = out
        if mode == "docs":
            words_np = words.cpu().numpy().view(np.uint16)
            for i, r in enumerate(batch):
                self._finish(r, _decode_docs(words_np[i]))
            return
        zeros = torch.zeros_like(self._keys_row)
        for i, r in enumerate(batch):
            qslab = RoaringSlab(
                keys=self._keys_row,
                kinds=torch.where(rc[i] > 0, tr.KIND_BITMAP,
                                  tr.KIND_EMPTY).to(torch.int32),
                cards=rc[i], nruns=zeros, payload=words[i], C=self.index.C)
            scores, rows = self.index.topk(qslab, r.k)
            self._finish(r, [(self.index.term_of(int(row)), int(s))
                             for s, row in zip(scores.cpu().tolist(),
                                               rows.cpu().tolist())])

    def _finish(self, r: _Request, value) -> None:
        self._results[r.rid] = value
        obs.registry().histogram("search.latency_us").record(
            (time.perf_counter() - r.t_submit) * 1e6)


def _decode_docs(words: np.ndarray) -> np.ndarray:
    """Bitmap-domain result rows ``u16[C, 4096]`` -> sorted doc ids. Rows
    are key-aligned to ``arange(C)``, so the flattened bit index IS the
    doc id (u16 words little-endian, bit order LSB-first)."""
    bits = np.unpackbits(words.reshape(-1).view(np.uint8),
                         bitorder="little")
    return np.nonzero(bits)[0].astype(np.int64)
