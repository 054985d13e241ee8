"""`repro_torch.obs` — the zero-dependency telemetry plane.

Two halves: :mod:`repro_torch.obs.trace` (context-manager spans with a
thread-local active stack, collected into exportable span trees) and
:mod:`repro_torch.obs.metrics` (a process-global registry of counters / gauges /
histograms). :mod:`repro_torch.obs.report` exports both as JSON / text and
cross-checks measured kernel-launch counts against the engine's analytic
launch model.

Off by default: ``enable()`` flips the tracing flag *and* subscribes the
launch-event hook in ``kernels/roaring/ops.py`` so every kernel dispatch
increments ``roaring.launches{entry,backend}`` and lands as an event on the
innermost open span. ``disable()`` undoes both. The metrics registry itself
has no switch — bare-int counters (ladder failures, cache hits) are cheap
enough to stay always-on — but instrumentation sites that cost real work
(host syncs for kind histograms, gauge refreshes, span bookkeeping) gate on
``enabled()``.
"""

from __future__ import annotations

from contextlib import contextmanager

from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               publish_service_gauges, registry,
                               reset_metrics)
from repro_torch.obs.report import (collect, environment, launch_crosscheck,
                              render_text, write_report)
from repro_torch.obs.trace import (Span, current_span, reset_traces, span,
                             span_trees, tracing)
from repro_torch.obs import trace as _trace

__all__ = [
    # switches
    "enable", "disable", "enabled", "telemetry_scope",
    # tracing
    "Span", "span", "current_span", "span_trees", "reset_traces",
    # metrics
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
    "reset_metrics", "record_kinds", "KIND_NAMES",
    "publish_service_gauges",
    # reporting
    "collect", "write_report", "render_text", "launch_crosscheck",
    "environment",
]

KIND_NAMES = ("empty", "array", "bitmap", "run")

_HOOKED = False


def _on_launch(ev) -> None:
    """Launch-hook subscriber: count the dispatch and pin it to the
    innermost open span as an event."""
    registry().counter("roaring.launches",
                       entry=ev.entry, backend=ev.backend).inc()
    sp = current_span()
    if sp is not None:
        sp.add_event("launch", entry=ev.entry, backend=ev.backend)


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
    """Turn telemetry off (the default). Collected spans/metrics are kept
    until ``reset_traces()`` / ``reset_metrics()``."""
    global _HOOKED
    _trace.set_tracing(False)
    if _HOOKED:
        from repro_torch.kernels.roaring import ops as kops
        kops.remove_launch_hook(_on_launch)
        _HOOKED = False


def enabled() -> bool:
    """Whether telemetry is currently on."""
    return _trace.tracing()


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


def record_kinds(name: str, kinds) -> None:
    """Bump per-container-kind counters (``<name>{kind=...}``) from a kinds
    tensor. The host sync only happens while telemetry is enabled."""
    if not enabled():
        return
    import torch
    counts = torch.bincount(kinds.detach().reshape(-1).to(torch.int64).cpu(),
                            minlength=len(KIND_NAMES)).tolist()
    reg = registry()
    for i, kname in enumerate(KIND_NAMES):
        n = int(counts[i]) if i < len(counts) else 0
        if n:
            reg.counter(name, kind=kname).inc(n)
