"""The device trace of a window, reduced to what the metrics read.

``DeviceTrace`` runs ``torch.profiler`` over part of the window with CUDA
activity alone (kernels, copies, sets), so the host pays for no record of
its own operations. It brackets that part with one marker op at each end,
each launched on an idle, synchronised device: the first and the last
device events of the trace, which pin the window on the device's clock and
map the host's clock onto it. ``summary`` then gives:

* ``busy_s``: the union of device intervals inside the window (one
  stream, but overlaps are merged all the same), markers left out;
* ``window_s``: the window's length on the device's clock;
* ``device_ops``: device time by operation name, most first;
* ``idle_gaps``: device idle time inside the window by what the host was
  doing, as the spans the benchmark records around its calls into the
  program name it (``(client)`` where no call was open).
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

__all__ = ["DeviceTrace", "TraceSummary", "merge", "attribute_gaps",
           "warm_profiler"]

NAME_CHARS = 96
TOP = 10


@dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    n_events: int = 0


def merge(intervals):
    """Sorted, disjoint union of ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def attribute_gaps(gaps, spans, outside="(client)"):
    """Split each gap ``(start, end)`` over the host spans ``(start, end,
    name)`` (disjoint, sorted) it overlaps; the rest goes to ``outside``.
    -> {name: seconds} in the units of the inputs."""
    out = defaultdict(float)
    j = 0
    for gs, ge in gaps:
        while j < len(spans) and spans[j][1] <= gs:
            j += 1
        covered = 0.0
        k = j
        while k < len(spans) and spans[k][0] < ge:
            s, e, name = spans[k]
            ov = min(e, ge) - max(s, gs)
            if ov > 0:
                out[name] += ov
                covered += ov
            k += 1
        out[outside] += (ge - gs) - covered
    return dict(out)


def warm_profiler(torch) -> None:
    """Start and stop the profiler once, so that its first start (seconds,
    setting up the device's tracing) falls in set-up and not mid-window."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
    torch.cuda.synchronize()


class DeviceTrace:
    """``with DeviceTrace(torch) as tr: ... window ...; tr.close_window()``
    then ``tr.summary(spans)``; host times are ``time.monotonic()``."""

    def __init__(self, torch):
        from torch.profiler import ProfilerActivity, profile
        self.torch = torch
        self._marker = torch.zeros(1, device="cuda")
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.t_open = self.t_close = None

    def _mark(self) -> float:
        self.torch.cuda.synchronize()
        t = time.monotonic()
        self._marker.add_(1)
        self.torch.cuda.synchronize()
        return t

    def __enter__(self):
        self.torch.cuda.synchronize()
        self._prof.__enter__()
        self.t_open = self._mark()
        return self

    def close_window(self) -> None:
        self.t_close = self._mark()

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        return False

    def summary(self, spans) -> Optional[TraceSummary]:
        """None when the trace holds no device event besides the markers."""
        events = []
        for e in self._prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith("CUDA"):
                events.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                               e.name()))
        events.sort()
        if len(events) < 3:
            return None
        first, last, work = events[0], events[-1], events[1:-1]
        w0, w1 = first[1], last[0]
        clipped = [(max(s, w0), min(e, w1)) for s, e, _ in work
                   if e > w0 and s < w1]
        busy = merge(clipped)
        busy_ns = sum(e - s for s, e in busy)
        by_name = defaultdict(int)
        for s, e, name in work:
            by_name[name[:NAME_CHARS]] += e - s
        gaps, t = [], w0
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if w1 > t:
            gaps.append((t, w1))
        offset = first[0] - self.t_open * 1e9        # host ns -> device ns
        host = [(s * 1e9 + offset, e * 1e9 + offset, n) for s, e, n in spans]
        idle = attribute_gaps(gaps, host)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gap_top = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
        return TraceSummary(
            busy_s=busy_ns / 1e9, window_s=(w1 - w0) / 1e9,
            device_ops=[[n, v / 1e9] for n, v in top],
            idle_gaps=[[n, v / 1e9] for n, v in gap_top if v > 0],
            n_events=len(work))
