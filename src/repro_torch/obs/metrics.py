"""Process-global metrics registry: counters, gauges, histograms.

Pure Python, so every layer — kernel launch hooks, the query engine's
degradation ladder, the search service's slab cache, the spans' self-time
counters — can publish without import cycles or device round trips.
Metrics are keyed by ``(name, sorted labels)``
(``roaring.launches{backend=cuda,entry=fused_tree}``).

Counters are plain Python numbers guarded by the GIL (an increment is a
dict lookup and an add — cheap enough for always-on accounting like the
ladder's failure counters or the store's build phases), so the registry
has no on/off switch; span bookkeeping and gauge refreshes gate on their
own conditions (``repro_torch.obs.trace``). The spans' counters are
brought up to date by a collector the registry runs before each read and
reset, so read them through ``value``, ``total`` or ``counters``. A reset
zeroes every metric in place, so a metric object fetched once stays the
registry's.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "registry", "reset_metrics"]

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Dict[str, Any]) -> _Key:
    return name, tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic (between resets) event count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Last-written point-in-time value (queue depth, cache entries, ...)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v

    def reset(self) -> None:
        self.value = 0.0


class Histogram:
    """Power-of-two-bucketed value distribution (count/sum/min/max kept
    exact; buckets index ``floor(log2(value))``, with <1 in bucket 0)."""

    __slots__ = ("count", "sum", "min", "max", "buckets")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.buckets: Dict[int, int] = {}

    def record(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        b = 0 if v < 1.0 else int(math.log2(v)) + 1
        self.buckets[b] = self.buckets.get(b, 0) + 1

    def reset(self) -> None:
        self.__init__()


class MetricsRegistry:
    """Name+label-keyed metric store; metrics are created on first use."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[_Key, Counter] = {}
        self._gauges: Dict[_Key, Gauge] = {}
        self._histograms: Dict[_Key, Histogram] = {}
        self._collectors: List[Callable[[], None]] = []

    def add_collector(self, fn: Callable[[], None]) -> None:
        """Have ``fn`` bring its metrics up to date before every read
        (``value``, ``total``, ``counters``) and reset — how the spans
        publish their self times outside the calls they time."""
        self._collectors.append(fn)

    def _collect(self) -> None:
        for fn in self._collectors:
            fn()

    def _get(self, table: dict, cls, name: str, labels: dict):
        k = _key(name, labels)
        m = table.get(k)
        if m is None:
            with self._lock:
                m = table.setdefault(k, cls())
        return m

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get(self._counters, Counter, name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get(self._gauges, Gauge, name, labels)

    def histogram(self, name: str, **labels: Any) -> Histogram:
        return self._get(self._histograms, Histogram, name, labels)

    def value(self, name: str, **labels: Any) -> float:
        """Current value of a counter or gauge (0 when never touched)."""
        self._collect()
        k = _key(name, labels)
        if k in self._counters:
            return self._counters[k].value
        if k in self._gauges:
            return self._gauges[k].value
        return 0

    def total(self, name: str, **labels: Any) -> int:
        """Sum of every counter named ``name`` whose labels include all the
        given ones (e.g. launches for one ``entry`` across backends)."""
        self._collect()
        want = set((k, str(v)) for k, v in labels.items())
        return sum(c.value for (n, lbl), c in list(self._counters.items())
                   if n == name and want <= set(lbl))

    def counters(self) -> Iterable[Tuple[_Key, Counter]]:
        """Every counter as ``((name, sorted label pairs), Counter)``."""
        self._collect()
        return list(self._counters.items())

    def reset(self) -> None:
        """Zero every metric in place (test isolation / fresh windows)."""
        self._collect()
        with self._lock:
            for table in (self._counters, self._gauges, self._histograms):
                for m in table.values():
                    m.reset()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry every instrumented layer publishes to."""
    return _REGISTRY


def reset_metrics() -> None:
    """Zero the process-global registry."""
    _REGISTRY.reset()


def publish_service_gauges(prefix: str, *, queue_depth: int, active: int,
                           requeues: int, steps: int, **extra) -> None:
    """One gauge vocabulary for every request-serving loop.

    Both admission-queue engines — the token server (``serve.engine``) and
    the search service (``search.service``) — publish the same four gauges
    under their own prefix (``{prefix}.queue_depth`` / ``.active_seqs`` /
    ``.requeues`` / ``.steps``), so a reader reads backpressure
    identically across planes. ``extra`` adds
    engine-specific gauges under the same prefix (page-pool occupancy,
    cache residency, ...). Call sites gate on ``obs.enabled()`` — gauge
    refreshes are part of the pay-only-when-watching contract.
    """
    reg = registry()
    reg.gauge(f"{prefix}.queue_depth").set(queue_depth)
    reg.gauge(f"{prefix}.active_seqs").set(active)
    reg.gauge(f"{prefix}.requeues").set(requeues)
    reg.gauge(f"{prefix}.steps").set(steps)
    for k, v in extra.items():
        reg.gauge(f"{prefix}.{k}").set(v)
