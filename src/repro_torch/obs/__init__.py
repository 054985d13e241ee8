"""`repro_torch.obs` — the telemetry plane.

Two halves: :mod:`repro_torch.obs.trace` (context-manager spans with a
thread-local stack of open spans, collected into span trees, per-name
self-time counters and a flat ``timeline()``) and
:mod:`repro_torch.obs.metrics` (a process-global registry of counters /
gauges / histograms).

Spans record while ``enable()`` is on or while a ``torch.profiler``
profile is running: profile the process with ``torch.profiler`` and the
store's and engine's spans come with it, on the same monotonic clock.
Under a root span, every phase of a store call is named ``store.*``,
``index.*`` or ``device.wait`` (the host blocked on the card), so the
``span.self_s`` counters of the three split each call's time.

``enable()`` also subscribes the launch-event hook in
``kernels/roaring/ops.py``, so every kernel dispatch increments
``roaring.launches{entry,backend}``; ``disable()`` undoes both. The
metrics registry has no switch: bare-number counters (ladder failures,
cache hits, build phases) are cheap enough to stay always-on. Recording
adds no host sync.
"""

from __future__ import annotations

from contextlib import contextmanager

from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                                     publish_service_gauges, registry,
                                     reset_metrics)
from repro_torch.obs.trace import (Span, current_span, reset_traces, span,
                                   span_trees, timeline)
from repro_torch.obs import trace as _trace

__all__ = [
    # switches
    "enable", "disable", "enabled", "telemetry_scope",
    # tracing
    "Span", "span", "current_span", "span_trees", "timeline",
    "reset_traces",
    # metrics
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
    "reset_metrics", "publish_service_gauges",
]

_HOOKED = False


def _on_launch(ev) -> None:
    """Launch-hook subscriber: count the dispatch."""
    registry().counter("roaring.launches",
                       entry=ev.entry, backend=ev.backend).inc()


def enable() -> None:
    """Turn telemetry on: record spans and subscribe the kernel launch
    hook. Idempotent."""
    global _HOOKED
    _trace.set_tracing(True)
    if not _HOOKED:
        from repro_torch.kernels.roaring import ops as kops
        kops.add_launch_hook(_on_launch)
        _HOOKED = True


def disable() -> None:
    """Turn telemetry off (the default; a running ``torch.profiler`` still
    records spans). Collected spans/metrics are kept until
    ``reset_traces()`` / ``reset_metrics()``."""
    global _HOOKED
    _trace.set_tracing(False)
    if _HOOKED:
        from repro_torch.kernels.roaring import ops as kops
        kops.remove_launch_hook(_on_launch)
        _HOOKED = False


def enabled() -> bool:
    """Whether ``enable()`` is on (spans also record under a profiler)."""
    return _trace._ENABLED


@contextmanager
def telemetry_scope(on: bool = True):
    """Temporarily force telemetry on (default) or off, restoring the
    previous state on exit — e.g. ``with telemetry_scope(): store.query(p)``
    or ``with telemetry_scope(on=False):`` around a timing window."""
    was = enabled()
    (enable if on else disable)()
    try:
        yield
    finally:
        (enable if was else disable)()
