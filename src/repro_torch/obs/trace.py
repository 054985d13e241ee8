"""Context-manager spans: the tracing half of the telemetry plane.

A span measures one phase of a query's life (``span("store.query")`` →
``span("store.execute")`` → kernel-launch events) with monotonic wall
times, arbitrary attributes, and point-in-time events. Spans nest through a
thread-local active-span stack; a span opened while another is active
becomes its child, and completed *root* spans are collected into a bounded
process-global list exportable as a span tree (``span_trees()``).

Cost contract: tracing is **off by default**. When disabled, ``span()``
returns a shared no-op context manager — one attribute read and two no-op
method calls per span site, never an allocation — so instrumented hot paths
pay almost nothing. Spans wrap *dispatch* (Python-level phases around
kernel launches); they never reach into a kernel, so a span measures host
time up to the launch, not device time, unless its body synchronizes.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Span", "span", "current_span", "span_trees", "reset_traces",
           "set_tracing", "tracing"]

_MAX_ROOT_SPANS = 4096         # bounded collection: drop oldest roots

_ENABLED = False               # module-global fast flag (obs.enable flips it)
_LOCK = threading.Lock()
_FINISHED: List["Span"] = []   # completed root spans, oldest first
_TLS = threading.local()


def set_tracing(on: bool) -> None:
    """Flip the process-wide tracing flag (use ``repro_torch.obs.enable()`` /
    ``disable()`` — they also manage the kernel launch-hook subscription)."""
    global _ENABLED
    _ENABLED = bool(on)


def tracing() -> bool:
    """Whether spans are currently being recorded."""
    return _ENABLED


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


class Span:
    """One timed phase: name, monotonic start/end, attrs, events, children.

    ``duration_s`` is ``None`` while the span is open. ``events`` are
    point-in-time markers (e.g. one per kernel-launch dispatch) recorded at
    an offset from the span start.
    """

    __slots__ = ("name", "attrs", "events", "children", "t0", "t1", "status")

    def __init__(self, name: str, attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.events: List[Dict[str, Any]] = []
        self.children: List[Span] = []
        self.t0 = time.monotonic()
        self.t1: Optional[float] = None
        self.status = "open"

    @property
    def duration_s(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def add_event(self, name: str, **attrs: Any) -> None:
        ev = {"name": name, "offset_s": time.monotonic() - self.t0}
        if attrs:
            ev.update(attrs)
        self.events.append(ev)

    def to_dict(self) -> dict:
        """JSON-exportable span tree rooted here."""
        d: dict = {"name": self.name, "status": self.status,
                   "duration_s": self.duration_s}
        if self.attrs:
            d["attrs"] = {k: _jsonable(v) for k, v in self.attrs.items()}
        if self.events:
            d["events"] = [
                {k: _jsonable(v) for k, v in ev.items()}
                for ev in self.events]
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d

    def __repr__(self) -> str:
        dur = self.duration_s
        return (f"Span({self.name!r}, {self.status}, "
                f"{'open' if dur is None else f'{dur * 1e3:.2f}ms'}, "
                f"{len(self.children)} children)")


class _NullSpan:
    """Shared do-nothing span handed out when tracing is disabled."""

    __slots__ = ()

    def set_attr(self, key: str, value: Any) -> None:
        pass

    def add_event(self, name: str, **attrs: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()


class span:
    """``with span("store.query", fused=True) as sp:`` — record one phase.

    Disabled tracing yields the shared no-op span. An exception escaping the
    body marks the span ``status="error"`` (and records the exception type)
    before propagating — fallback rungs show up as errored child spans.
    """

    __slots__ = ("_name", "_attrs", "_span")

    def __init__(self, name: str, **attrs: Any):
        self._name = name
        self._attrs = attrs
        self._span: Optional[Span] = None

    def __enter__(self):
        if not _ENABLED:
            return _NULL_SPAN
        s = Span(self._name, self._attrs)
        st = _stack()
        if st:
            st[-1].children.append(s)
        st.append(s)
        self._span = s
        return s

    def __exit__(self, etype, evalue, tb):
        s = self._span
        if s is None:
            return False
        self._span = None
        s.t1 = time.monotonic()
        if etype is not None:
            s.status = "error"
            s.attrs.setdefault("error", etype.__name__)
        else:
            s.status = "ok"
        st = _stack()
        # tolerate enable/disable flips mid-span: pop only what we pushed
        if s in st:
            while st and st[-1] is not s:
                st.pop()
            st.pop()
        if not st:
            with _LOCK:
                _FINISHED.append(s)
                if len(_FINISHED) > _MAX_ROOT_SPANS:
                    del _FINISHED[: len(_FINISHED) - _MAX_ROOT_SPANS]
        return False


def current_span() -> Optional[Span]:
    """The innermost active span on this thread, or ``None`` (also ``None``
    whenever tracing is disabled)."""
    if not _ENABLED:
        return None
    st = _stack()
    return st[-1] if st else None


def span_trees() -> List[Span]:
    """Snapshot of the completed root spans (each the root of its tree)."""
    with _LOCK:
        return list(_FINISHED)


def reset_traces() -> None:
    """Drop every collected root span and this thread's open-span stack."""
    with _LOCK:
        _FINISHED.clear()
    _stack().clear()


def _jsonable(v: Any):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)
