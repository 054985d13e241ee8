"""Seeded closed-loop load generation for the search service.

``zipf_queries`` draws query terms from the same Zipf rank distribution the
corpus generator (``gen_zipf_postings``) sizes postings by, so "hot" means
the same thing to the data, the cache, and the load.
``run_closed_loop`` drives a ``SearchService`` with a fixed concurrency
window — every completion immediately admits the next request, the classic
closed-loop harness — and reports QPS, p50/p99 latency (estimated from a
``repro_torch.obs`` log2 histogram), and the cache hit rate over the run.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import List, Sequence

import numpy as np

import repro_torch.obs as obs
from repro_torch.search import service as _svc

__all__ = ["LoadStats", "gen_zipf_postings", "zipf_queries",
           "run_closed_loop", "percentile"]


@dataclasses.dataclass
class LoadStats:
    """One closed-loop run's scorecard (latencies in microseconds)."""

    n_requests: int
    concurrency: int
    wall_s: float
    qps: float
    p50_us: float
    p99_us: float
    hit_rate: float
    latency: obs.Histogram = dataclasses.field(repr=False)

    def row_dict(self) -> dict:
        return {"qps": round(self.qps, 1), "p50_us": round(self.p50_us, 1),
                "p99_us": round(self.p99_us, 1),
                "hit_rate": round(self.hit_rate, 4)}


def gen_zipf_postings(n_terms: int, n_docs: int, s: float,
                      seed: int) -> List[np.ndarray]:
    """Zipf-sized posting lists over a ``[0, n_docs)`` document universe:
    term ``t`` (0-ranked) draws ``~ 0.5 * n_docs / (t+1)^s`` doc ids
    uniformly, so head terms are dense (bitmap containers) and the tail is
    sparse (array containers)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_terms + 1, dtype=np.float64)
    sizes = np.maximum(1, (0.5 * n_docs * ranks ** -s)).astype(np.int64)
    return [np.unique(rng.integers(0, n_docs, size=int(sz))) for sz in sizes]


def percentile(hist: obs.Histogram, q: float) -> float:
    """Percentile estimate from a log2-bucketed histogram: the upper bound
    ``2^b`` of the bucket holding the q-th ranked sample (<= one octave of
    overestimate — the histogram's resolution contract)."""
    if hist.count == 0:
        return 0.0
    target = max(1, math.ceil(q / 100.0 * hist.count))
    cum = 0
    for b in sorted(hist.buckets):
        cum += hist.buckets[b]
        if cum >= target:
            return float(2.0 ** b) if b > 0 else 1.0
    return float(hist.max)


def zipf_queries(terms: Sequence[str], n_queries: int, s: float, seed: int,
                 *, terms_per_query: int = 2, op: str = "and") -> List:
    """``n_queries`` same-shape query trees whose terms are drawn (without
    replacement per query) from rank distribution ``p(r) ∝ 1/r^s`` over
    ``terms`` in the given order — rank 0 is the hottest. Same shape means
    every tree batches with every other."""
    if terms_per_query > len(terms):
        raise ValueError("terms_per_query exceeds the vocabulary")
    mk = {"and": _svc.and_, "or": _svc.or_}[op]
    rng = np.random.default_rng(seed)
    p = np.arange(1, len(terms) + 1, dtype=np.float64) ** -s
    p /= p.sum()
    out = []
    for _ in range(n_queries):
        idx = rng.choice(len(terms), size=terms_per_query, replace=False,
                         p=p)
        out.append(mk(*[_svc.term(terms[i]) for i in idx]))
    return out


def run_closed_loop(service, queries: Sequence, *, concurrency: int = 8,
                    mode: str = "count", k: int = 10) -> LoadStats:
    """Drive ``service`` with a closed loop of ``concurrency`` in-flight
    requests until every query completes. Latency is client-observed
    (submit to poll) in a local log2 histogram; the hit rate is the delta
    of the service's cache counters over the run."""
    reg = obs.registry()
    h0 = reg.value("search.cache.hits")
    m0 = reg.value("search.cache.misses")
    lat = obs.Histogram()
    pending = deque(queries)
    inflight = {}
    t0 = time.perf_counter()
    while pending or inflight:
        while pending and len(inflight) < concurrency:
            q = pending.popleft()
            inflight[service.submit(q, mode, k)] = time.perf_counter()
        service.step()
        now = time.perf_counter()
        for rid in service.poll():
            lat.record((now - inflight.pop(rid)) * 1e6)
    wall = time.perf_counter() - t0
    hits = reg.value("search.cache.hits") - h0
    misses = reg.value("search.cache.misses") - m0
    return LoadStats(
        n_requests=len(queries), concurrency=concurrency, wall_s=wall,
        qps=len(queries) / wall if wall > 0 else 0.0,
        p50_us=percentile(lat, 50), p99_us=percentile(lat, 99),
        hit_rate=hits / max(1.0, hits + misses), latency=lat)
