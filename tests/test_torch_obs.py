"""The port's telemetry plane on the CPU: when spans record, what a span
records, the timeline, the build's phase counters and the benchmark's
readers of them.

Spans record while ``obs.enable()`` is on or a ``torch.profiler`` profile
runs; here a CPU-only profile turns them on, as the benchmark's device
trace does on the card. The store is tiny, so the file takes a few
seconds.
"""

import sys
import time
import tracemalloc
from pathlib import Path

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from _torch_threads import share_cores_between_workers
import repro_torch.obs as obs
from repro_torch import store as ST
from repro_torch.obs import trace as obs_trace

share_cores_between_workers()

REPO = Path(__file__).resolve().parents[1]
SEED = 2501


def _records(n=5000):
    rng = np.random.default_rng(SEED)
    return {"a": rng.integers(0, 5, n), "b": rng.integers(0, 300, n),
            "q": rng.integers(0, 50, n)}


def _pred():
    return ST.and_(ST.eq("a", 2), ST.range_("b", 40, 200))


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.disable()
    obs.reset_metrics()
    obs.reset_traces()
    yield
    obs.disable()
    obs.reset_metrics()
    obs.reset_traces()


@pytest.fixture(scope="module")
def store():
    s = ST.BitmapStore.build(_records(), bsi=("b", "q"), device="cpu")
    s.count(_pred(), fused=True)            # compile the plans ahead
    s.sum_("q", _pred())
    return s


def _walk(sp):
    yield sp
    for c in sp.children:
        yield from _walk(c)


def _span_totals():
    reg = obs.registry()
    return (reg.value("span.roots"), reg.total("span.n"),
            reg.total("span.self_s"))


def test_off_path_hands_back_the_shared_noop_and_moves_nothing(store):
    root = obs.span("store.count")
    assert obs.span("store.sum_") is root
    with root:
        inner = obs.span("device.wait")
        assert inner is not root and obs.span("index.gather") is inner
        assert obs.current_span() is None
    assert obs.current_span() is None
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(200):
            with obs.span("store.count"):
                with obs.span("device.wait"):
                    pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.size_diff > 0
             and "/repro_torch/obs/" in d.traceback[0].filename]
    assert grown == []
    store.count(_pred(), fused=True)
    store.sum_("q", _pred())
    assert _span_totals() == (0, 0, 0)
    assert obs.span_trees() == [] and obs.timeline() == []


def _profiled(store):
    """A ``count`` and a ``sum_`` under a CPU-only profile, with
    ``time.monotonic()`` read before and after."""
    t_before = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU]):
        got = (store.count(_pred(), fused=True), store.sum_("q", _pred()))
    t_after = time.monotonic()
    return got, t_before, t_after


def test_profiled_calls_record_one_root_each_with_its_call_id(store):
    got, _, _ = _profiled(store)
    rows = np.nonzero((_records()["a"] == 2) & (_records()["b"] >= 40)
                      & (_records()["b"] <= 200))[0]
    assert got == (rows.size, int(_records()["q"][rows].sum()))
    roots = obs.span_trees()
    assert [r.name for r in roots] == ["store.count", "store.sum_"]
    assert roots[0].call != roots[1].call
    for r in roots:
        spans = list(_walk(r))
        assert {s.call for s in spans} == {r.call}
        assert all(s.status == "ok" for s in spans)
        assert sum(s.self_s for s in spans) == pytest.approx(r.duration_s,
                                                             rel=1e-9)
        assert {s.name.split(".")[0] for s in spans} <= {"store", "index",
                                                         "device"}
    count, sum_ = roots
    assert [c.name for c in count.children] == ["store.compile",
                                                "store.execute",
                                                "device.wait"]
    assert "index.gather" in {s.name for s in _walk(count)}
    assert [c.name for c in sum_.children] == ["store.query", "index.score",
                                               "device.wait"]
    assert "index.finalize" in {s.name for s in _walk(sum_.children[0])}
    reg = obs.registry()
    n = sum(1 for r in roots for _ in _walk(r))
    assert _span_totals() == (2, n, pytest.approx(
        sum(r.duration_s for r in roots), rel=1e-9))
    assert reg.value("span.n", span="device.wait") == sum(
        1 for r in roots for s in _walk(r) if s.name == "device.wait")
    store.count(_pred(), fused=True)         # the profile has stopped
    assert reg.value("span.roots") == 2 and len(obs.span_trees()) == 2
    obs.enable()
    store.count(_pred(), fused=True)
    assert reg.value("span.roots") == 3
    assert obs.span_trees()[-1].call > sum_.call


def test_counters_outlive_the_kept_trees_and_reset_with_the_registry(
        store):
    obs.enable()
    store.count(_pred(), fused=True)
    obs.reset_traces()
    assert obs.span_trees() == [] and _span_totals()[:2] == (1, 8)
    store.count(_pred(), fused=True)
    obs.reset_metrics()                      # zeroes the queued tree too
    assert _span_totals() == (0, 0, 0) and len(obs.span_trees()) == 1


def test_timeline_is_sorted_disjoint_and_innermost(store):
    _, t_before, t_after = _profiled(store)
    tl = obs.timeline()
    assert tl and tl == sorted(tl)
    assert t_before <= tl[0][0] and tl[-1][1] <= t_after
    for (s0, e0, _), (s1, _, _) in zip(tl, tl[1:]):
        assert s0 < e0 <= s1
    spans = [s for r in obs.span_trees() for s in _walk(r)]
    for s, e, name in tl:
        mid = (s + e) / 2
        inner = min((sp for sp in spans if sp.t0 <= mid <= sp.t1),
                    key=lambda sp: sp.duration_s)
        assert inner.name == name
    covered = sum(e - s for s, e, _ in tl)
    assert covered == pytest.approx(
        sum(r.duration_s for r in obs.span_trees()), rel=1e-9)


def test_build_fills_its_three_phases():
    reg = obs.registry()
    t = time.perf_counter()
    ST.BitmapStore.build(_records(2000), bsi=("q",), device="cpu")
    wall = time.perf_counter() - t
    phases = [reg.value("store.build_s", phase=p)
              for p in ("postings", "pack", "copy")]
    assert all(v > 0 for v in phases) and sum(phases) <= wall


def test_only_build_moves_the_build_phases(store):
    from repro_torch.search import index as SI
    reg = obs.registry()
    blob = store.save()
    ST.BitmapStore.load(blob, device="cpu")
    SI.PostingIndex.from_postings({"t": np.arange(0, 3000, 7)}, 4000,
                                  device="cpu")
    assert reg.total("store.build_s") == 0


def test_current_span_names_the_innermost_open_span():
    obs.enable()
    with obs.span("store.count"):
        root = obs.current_span()
        with obs.span("device.wait"):
            inner = obs.current_span()
        assert obs.current_span() == root
    assert obs.current_span() is None
    assert (root.name, inner.name) == ("store.count", "device.wait")
    assert inner.call == root.call and inner.t0 >= root.t0
    (tree,) = obs.span_trees()
    assert (tree.call, tree.t0, tree.children[0].t0) == (root.call, root.t0,
                                                         inner.t0)


def test_readers_read_the_registry():
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from portbench import bench
    reg = obs.registry()
    roots = reg.counter("span.roots")
    obs.reset_metrics()
    assert reg.counter("span.roots") is roots    # zeroed in place
    names = ("store.host_ms", "engine.host_ms", "device.wait_ms",
             "device.waits_per_call", "store.build_host_s")
    readers = {n: bench.load_reader(REPO, n) for n in names}
    assert all(readers[n](None) is None for n in names)
    roots.inc(4)
    for name, s in (("store.count", 0.004), ("store.compile", 0.002),
                    ("index.rung", 0.008), ("index.gather", 0.004),
                    ("device.wait", 0.002)):
        reg.counter("span.self_s", span=name).inc(s)
    reg.counter("span.n", span="device.wait").inc(8)
    for phase, s in (("postings", 3.0), ("pack", 1.0), ("copy", 0.5)):
        reg.counter("store.build_s", phase=phase).inc(s)
    want = {"store.host_ms": 1.5, "engine.host_ms": 3.0,
            "device.wait_ms": 0.5, "device.waits_per_call": 2.0,
            "store.build_host_s": 4.0}
    assert {n: readers[n](None) for n in names} == pytest.approx(want)
    assert obs_trace._roots() is roots
