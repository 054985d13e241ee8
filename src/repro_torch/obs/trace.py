"""Context-manager spans: the tracing half of the telemetry plane.

A span measures one phase of a call's life (``span("store.count")`` →
``span("store.execute")`` → ``span("device.wait")``) with start and end
on ``time.monotonic()``. Spans nest through a thread-local stack of open
spans: a span opened while another is open on its thread becomes its
child and inherits its call id.

When spans record: a span opened with no span open on its thread is a
*root*, and it decides once for its whole tree whether to record — it
records while ``repro_torch.obs.enable()`` is on or while a
``torch.profiler`` profile is running (torch's own Python flag,
``torch.autograd.profiler._is_profiler_enabled``, which every profiler
start sets whatever its activities). Spans opened under a root make no
check of their own: under a recording root they record, under any other
they are the shared no-op. So profiling a process with ``torch.profiler``
brings the program's spans with it, on the clock the profiler's host-side
markers use on Linux (``CLOCK_MONOTONIC``).

What a recording span leaves: its root's call id (a process counter,
taken when the root opens), its place in the root's tree, and its self
time (duration minus its children's durations) and count, added to the
registry's ``span.self_s{span=<name>}`` and ``span.n{span=<name>}``
counters; each closed root adds one to ``span.roots``. A span only pushes
its name and start and, when it closes, appends one record to its root's
list; the root, when it closes, queues its tree. The registry publishes
the queued trees' sums before every read and reset (and the root that
fills the queue to ``MAX_ROOT_SPANS`` does), so the calls being timed pay
for no sums. The counters are unbounded; the newest ``MAX_ROOT_SPANS``
root trees are kept as records of plain strings and numbers, which the
garbage collector stops tracking, so a traced run that fills them costs
the collector nothing. ``span_trees()`` builds ``Span`` trees from them
and ``timeline()`` the intervals of the innermost open span.

A span is used as a ``with`` statement's expression: ``span(name)`` pushes
the name, and entering the context starts the clock.

Cost contract: when nothing records, ``span(name)`` hands back one of two
shared no-op contexts and allocates nothing — a thread-local read and,
at a root, two flag reads more; the root marks its thread quiet while
open. A recording span builds no span object (it hands back its thread's
one shared context), leaves one record tuple, and makes no host sync: spans
wrap host phases around launches and waits, never a kernel, so a span's
time is the host's unless its body blocks on the card — and each such
body sits in a ``device.wait`` span.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import List, NamedTuple, Optional, Tuple

import torch.autograd.profiler as _profiler

from repro_torch.obs.metrics import registry

__all__ = ["Span", "OpenSpan", "span", "current_span", "span_trees",
           "reset_traces", "set_tracing", "timeline", "MAX_ROOT_SPANS"]

MAX_ROOT_SPANS = 1 << 15       # kept root trees (oldest dropped first)

_ENABLED = False               # module-global fast flag (obs.enable flips it)
_LOCK = threading.Lock()
_FINISHED: collections.deque = collections.deque(maxlen=MAX_ROOT_SPANS)
_PENDING: list = []            # closed root trees not yet in the registry
_CALL_IDS = itertools.count(1)
_now = time.monotonic
_COUNTERS: dict = {}           # span name -> (self_s, n); None -> span.roots


def set_tracing(on: bool) -> None:
    """Flip the process-wide tracing flag (use ``repro_torch.obs.enable()`` /
    ``disable()`` — they also manage the kernel launch-hook subscription)."""
    global _ENABLED
    _ENABLED = bool(on)


def _counters(name: str) -> tuple:
    """The ``(self_s, n)`` counters of span ``name``, fetched once (a reset
    zeroes them in place)."""
    c = _COUNTERS.get(name)
    if c is None:
        reg = registry()
        c = _COUNTERS[name] = (reg.counter("span.self_s", span=name),
                               reg.counter("span.n", span=name))
    return c


def _roots():
    """The ``span.roots`` counter, fetched once."""
    c = _COUNTERS.get(None)
    if c is None:
        c = _COUNTERS[None] = registry().counter("span.roots")
    return c


def _publish() -> None:
    """Add the closed root trees not yet published to the registry: each
    name's self time and count, and one ``span.roots`` a tree. Records come
    in the order the spans closed, children before their parent, so the
    children of a span at depth d are the records at depth d + 1 since the
    last span at depth d closed. The registry calls this before every read
    and reset."""
    with _LOCK:
        batch = _PENDING[:]
        del _PENDING[:len(batch)]
    if not batch:
        return
    acc: dict = {}                     # name -> [self_s, n]
    for _, records in batch:
        child: dict = {}               # depth -> durations awaiting a parent
        for name, t0, t1, depth, _ in records:
            d = t1 - t0
            s = d - child.pop(depth + 1, 0.0)
            child[depth] = child.get(depth, 0.0) + d
            a = acc.get(name)
            if a is None:
                acc[name] = [s, 1]
            else:
                a[0] += s
                a[1] += 1
    for name, (s, n) in acc.items():
        self_c, n_c = _counters(name)
        self_c.value += s
        n_c.value += n
    _roots().value += len(batch)


registry().add_collector(_publish)


class _Recorder:
    """A thread's spans: the one shared context of all its recording spans,
    and their state — the names and starts of the open recording spans
    (innermost last), the open root's call id and the records of its
    closed spans — and whether a root that does not record is open.
    Entering starts the clock of the span ``span()`` pushed last; leaving
    closes it and appends its record; a root, when it closes, queues its
    tree for the registry and keeps it."""

    __slots__ = ("names", "t0s", "call", "records", "quiet")

    def __init__(self):
        self.names: list = []
        self.t0s: list = []
        self.call = 0
        self.records: list = []
        self.quiet = False

    def __enter__(self) -> None:
        self.t0s.append(_now())

    def __exit__(self, etype, evalue, tb):
        t1 = _now()
        names = self.names
        if not names:                  # the stack was reset while open
            return False
        name = names.pop()
        depth = len(names)
        self.records.append((name, self.t0s.pop(), t1, depth, etype is None))
        if not depth:
            tree = (self.call, tuple(self.records))
            self.records = []
            _FINISHED.append(tree)
            _PENDING.append(tree)
            if len(_PENDING) >= MAX_ROOT_SPANS:
                _publish()
        return False

    def clear(self) -> None:
        self.names.clear()
        self.t0s.clear()
        self.records = []
        self.quiet = False


class _Local(threading.local):
    """Per-thread state: the thread's recorder."""

    def __init__(self):
        self.rec = _Recorder()


_TLS = _Local()


class OpenSpan(NamedTuple):
    """The innermost recording span open on a thread, as
    ``current_span()`` reads it."""

    name: str
    call: int
    t0: float


class Span:
    """One recorded phase of a kept root tree: name, call id, monotonic
    start and end, status (``"ok"``, or ``"error"`` when an exception
    left its body) and children."""

    __slots__ = ("name", "call", "t0", "t1", "status", "children")

    def __init__(self, name: str, call: int, t0: float, t1: float,
                 ok: bool, children: List["Span"]):
        self.name, self.call, self.t0, self.t1 = name, call, t0, t1
        self.status = "ok" if ok else "error"
        self.children = children

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    @property
    def self_s(self) -> float:
        """Duration less the children's durations."""
        return self.duration_s - sum(c.duration_s for c in self.children)

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, call {self.call}, {self.status}, "
                f"{self.duration_s * 1e3:.2f}ms, "
                f"{len(self.children)} children)")


def _tree(call: int, records) -> Span:
    """The root tree of one call from its records, which come in the
    order the spans closed (children before their parent)."""
    pending: dict = {}                 # depth -> closed spans awaiting it
    for name, t0, t1, depth, ok in records:
        sp = Span(name, call, t0, t1, ok, pending.pop(depth + 1, []))
        pending.setdefault(depth, []).append(sp)
    return pending[0][0]


class _NullSpan:
    """The shared span that records nothing, opened under a root that
    does not record."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, etype, evalue, tb):
        return False


class _NullRoot(_NullSpan):
    """The shared root that does not record: while open it marks its
    thread quiet, so that the spans under it are ``_NullSpan``s without a
    check of their own."""

    __slots__ = ()

    def __enter__(self) -> None:
        _TLS.rec.quiet = True

    def __exit__(self, etype, evalue, tb):
        _TLS.rec.quiet = False
        return False


_NULL_SPAN = _NullSpan()
_NULL_ROOT = _NullRoot()


def span(name: str):
    """``with span("store.query"):`` — record one phase.

    Under a recording root on this thread, a child span of it; under a
    root that does not record, the shared no-op span. With none open, a
    root that records when ``obs.enable()`` is on or a ``torch.profiler``
    profile runs, else the shared no-op root. Use it only as a ``with``
    statement's expression: a recording span is pushed here and timed from
    when it is entered. An exception escaping the body marks a recording
    span ``status="error"`` before propagating — fallback rungs show up as
    errored child spans.
    """
    rec = _TLS.rec
    names = rec.names
    if names:
        names.append(name)
        return rec
    if rec.quiet:
        return _NULL_SPAN
    if _ENABLED or _profiler._is_profiler_enabled:
        rec.call = next(_CALL_IDS)
        names.append(name)
        return rec
    return _NULL_ROOT


def current_span() -> Optional[OpenSpan]:
    """The innermost recording span open on this thread (its ``name``,
    ``call`` and ``t0``), or ``None``."""
    rec = _TLS.rec
    if not rec.t0s:
        return None
    return OpenSpan(rec.names[-1], rec.call, rec.t0s[-1])


def span_trees() -> List[Span]:
    """The kept root trees, oldest first, built anew from their records
    at each call."""
    kept = list(_FINISHED)
    return [_tree(call, records) for call, records in kept]


def timeline() -> List[Tuple[float, float, str]]:
    """The kept root trees as ``(t0, t1, name)`` intervals of the innermost
    open span, on ``time.monotonic()``: sorted and disjoint for calls made
    from one thread, empty intervals left out. The form
    ``portbench.yardstick.trace.attribute_gaps`` takes as its spans."""
    out: List[Tuple[float, float, str]] = []

    def walk(s: Span) -> None:
        t = s.t0
        for c in s.children:
            if c.t0 > t:
                out.append((t, c.t0, s.name))
            walk(c)
            t = c.t1
        if s.t1 > t:
            out.append((t, s.t1, s.name))

    for root in span_trees():
        walk(root)
    out.sort()
    return out


def reset_traces() -> None:
    """Drop every kept root tree and this thread's open spans. Call ids
    keep counting, so no two calls of a process share one."""
    _publish()
    _FINISHED.clear()
    _TLS.rec.clear()
