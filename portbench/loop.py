"""The client: a closed loop, where every completion lets the next request
in.

``serial_loop`` drives a server with one blocking ``request`` call (one
client of the store), takes requests from a pool in turn, times each on
the client's clock, and stops when the window closes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

__all__ = ["Outcome", "serial_loop"]


@dataclass
class Outcome:
    """``answers[i]``: the answer of the ``i``-th request submitted;
    ``latency_s[i]`` / ``done_at[i]``: its latency and the time it came,
    for requests completed inside the window; ``submitted``: requests
    submitted before the window closed."""

    submitted: int = 0
    answers: Dict[int, object] = field(default_factory=dict)
    latency_s: Dict[int, float] = field(default_factory=dict)
    done_at: Dict[int, float] = field(default_factory=dict)
    t_open: float = 0.0
    t_close: float = 0.0

    def window_latencies(self) -> List[float]:
        return list(self.latency_s.values())


def serial_loop(server, pool, seconds: float, n_max: int = None,
                window=None) -> Outcome:
    """One client: ``server.request(pool[i % len(pool)])`` back to back
    until the window closes (or ``n_max`` requests, for a warm-up);
    ``window`` is ticked before each request and closed at the end."""
    out = Outcome()
    clock = time.perf_counter
    out.t_open = clock()
    t_end = out.t_open + seconds
    i = 0
    while clock() < t_end and (n_max is None or i < n_max):
        if window is not None:
            window.tick(clock())
        t0 = clock()
        ans = server.request(pool[i % len(pool)])
        now = clock()
        out.answers[i] = ans
        if now <= t_end:
            out.latency_s[i] = now - t0
            out.done_at[i] = now
        i += 1
    out.submitted = i
    out.t_close = min(clock(), t_end)
    if window is not None:
        window.close()
    return out
