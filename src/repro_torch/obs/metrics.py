"""Process-global metrics registry: counters, gauges, histograms.

Zero-dependency (pure Python) so every layer — kernel launch hooks, the
query engine's degradation ladder, the search service's slab cache — can publish without import cycles or device round trips. Metrics
are keyed by ``(name, sorted labels)``; the rendered form is Prometheus-ish
(``roaring.launches{backend=cuda,entry=fused_tree}``).

Counters are plain Python ints guarded by the GIL (increments are a dict
lookup + integer add — cheap enough for always-on accounting like the
ladder's failure counters), so the registry itself has no on/off switch;
*instrumentation sites* that would cost real work (host syncs for kind
histograms, span bookkeeping) gate on ``repro_torch.obs.enabled()`` instead.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, Iterable, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "registry", "reset_metrics", "render_key"]

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Dict[str, Any]) -> _Key:
    return name, tuple(sorted((k, str(v)) for k, v in labels.items()))


def render_key(key: _Key) -> str:
    """``(name, labels)`` -> ``name{k=v,...}`` (plain ``name`` unlabeled)."""
    name, labels = key
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


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

    def to_dict(self) -> dict:
        return {"count": self.count, "sum": self.sum, "min": self.min,
                "max": self.max,
                "buckets": {f"<2^{b}": n
                            for b, n in sorted(self.buckets.items())}}


class MetricsRegistry:
    """Name+label-keyed metric store; metrics are created on first use."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[_Key, Counter] = {}
        self._gauges: Dict[_Key, Gauge] = {}
        self._histograms: Dict[_Key, Histogram] = {}

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
        k = _key(name, labels)
        if k in self._counters:
            return self._counters[k].value
        if k in self._gauges:
            return self._gauges[k].value
        return 0

    def total(self, name: str, **labels: Any) -> int:
        """Sum of every counter named ``name`` whose labels include all the
        given ones (e.g. launches for one ``entry`` across backends)."""
        want = set((k, str(v)) for k, v in labels.items())
        return sum(c.value for (n, lbl), c in list(self._counters.items())
                   if n == name and want <= set(lbl))

    def counters(self) -> Iterable[Tuple[_Key, Counter]]:
        return list(self._counters.items())

    def remove(self, name: str) -> None:
        """Drop every metric (any type, any labels) with this name."""
        with self._lock:
            for table in (self._counters, self._gauges, self._histograms):
                for k in [k for k in table if k[0] == name]:
                    del table[k]

    def reset(self) -> None:
        """Forget every metric (test isolation / fresh report windows)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    def snapshot(self) -> dict:
        """JSON-exportable state: rendered-name -> value tables."""
        return {
            "counters": {render_key(k): c.value
                         for k, c in sorted(self._counters.items())},
            "gauges": {render_key(k): g.value
                       for k, g in sorted(self._gauges.items())},
            "histograms": {render_key(k): h.to_dict()
                           for k, h in sorted(self._histograms.items())},
        }


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
    ``.requeues`` / ``.steps``), so dashboards and the telemetry report
    read backpressure identically across planes. ``extra`` adds
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
