"""The harness: find a cell's files by name, run it once, build its line.

``BENCHMARK.json`` names each cell's configuration and traffic mix and
every metric. The harness finds them as files under the checkout root:

* a configuration at the ``file`` its entry gives; its ``system`` key
  names the driver, ``portbench/systems/<system>.py``;
* a traffic mix at ``portbench/traffic/<traffic>.json``;
* a metric's reader at ``portbench/metrics/<metric name>.py``, whose
  ``read(run)`` returns the number or None when the run holds nothing to
  read (the metric is then left out of the line).

So a later change adds a configuration, a traffic mix, a cell or a metric
by adding files and entries, and edits none of these.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

from portbench.yardstick import judge

__all__ = ["FORBIDDEN", "Run", "RunRecord", "Window", "load_benchmark",
           "find_cell", "cell_metrics", "load_reader", "run_workload",
           "result_line", "forbidden_modules", "use_program", "load_kernels",
           "device_info", "setup_line"]

BENCH_DIR = Path(__file__).resolve().parent.name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_benchmark(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str):
    """(cell entry, configuration entry) of the cell ``name``."""
    cells = [w for w in bench["workloads"] if w["name"] == name]
    if len(cells) != 1:
        raise KeyError(f"no cell named {name!r} in BENCHMARK.json")
    cell = cells[0]
    cfgs = [c for c in bench["configs"] if c["name"] == cell["config"]]
    if len(cfgs) != 1:
        raise KeyError(f"cell {name!r} names configuration "
                       f"{cell['config']!r}, which BENCHMARK.json lacks")
    return cell, cfgs[0]


def cell_metrics(bench: dict, name: str, trace: bool) -> List[dict]:
    """The metrics a run of cell ``name`` reports: its end-to-end metrics
    with ``--trace 0``, its per-layer metrics with ``--trace 1``."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in moved
                             else [])]


def load_reader(root: Path, metric: str) -> Callable:
    path = Path(root) / BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def use_program(root: Path):
    """Import the port from the checkout's ``src``; raise when it is not
    there, so that a run never measures some other copy."""
    src = (Path(root) / "src").resolve()
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    import repro_torch
    if src not in Path(repro_torch.__file__).resolve().parents:
        raise ImportError(f"repro_torch comes from {repro_torch.__file__}, "
                          f"not from {src}")
    return repro_torch


def load_kernels(run) -> None:
    """Load (building at the first run in a checkout) the port's CUDA
    kernel library; nothing to load on the CPU."""
    if run.device == "cuda":
        from repro_torch.kernels import build
        build.library()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one that may not be loaded,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class RunRecord:
    """What one run leaves for the metric readers."""

    system: str
    device: dict
    setup: Dict[str, float]
    setup_s: float
    window_s: float
    latencies_s: List[float]
    attempted: int
    failed: int
    counters: Dict[str, float] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)
    trace: object = None
    window_bytes: Optional[Callable[[], Optional[int]]] = None
    checks: dict = field(default_factory=dict)
    counted_requests: int = 0      # the requests ``counters`` cover

    @property
    def n_done(self) -> int:
        """Requests completed inside the window."""
        return len(self.latencies_s)


class Run:
    """One run's context: inputs, phase clock, host spans, log lines."""

    def __init__(self, root, config, traffic, seed, seconds, trace, device,
                 t_start, server=None, log=print):
        self.root = Path(root)
        self.config, self.traffic = config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t_start = device, t_start
        self.server, self.log = server, log
        self.setup: Dict[str, float] = {}
        self.spans: List[tuple] = []
        self.torch = None

    @contextmanager
    def phase(self, name: str):
        """Time one set-up phase (the device synchronised at its end)."""
        t = time.perf_counter()
        yield
        self.sync()
        self.setup[name] = self.setup.get(name, 0.0) + (
            time.perf_counter() - t)

    def sync(self) -> None:
        if self.torch is not None and self.device == "cuda":
            self.torch.cuda.synchronize()

    def fresh_peak(self) -> None:
        """Drop what the benchmark's own inputs held on the card, so that
        the peak read later is the program's."""
        if self.device == "cuda":
            self.torch.cuda.empty_cache()
            self.torch.cuda.reset_peak_memory_stats()

    def call(self, name: str, fn, *args):
        """``fn(*args)``; in a traced run also a host span ``name``."""
        if not self.trace:
            return fn(*args)
        t0 = time.monotonic()
        try:
            return fn(*args)
        finally:
            self.spans.append((t0, time.monotonic(), name))


class Window:
    """Opens and closes the measured window around a loop: the set-up
    line, the set-up time, the server's counters at each end, and in a
    traced run on the card the device trace over ``TRACE_S`` seconds in
    the middle of the window (so that the trace stays small), counted
    from when the profiler has started."""

    TRACE_S = 10.0

    def __init__(self, run, server):
        self.run, self.server = run, server
        self.trace = None
        self.before = self.after = None
        self.setup_s = None
        self.trace_from = self.trace_to = self.span = None
        self.traced = None              # (start, end) on the host's clock

    def open(self) -> None:
        run = self.run
        if run.trace and run.device == "cuda":
            from portbench.yardstick.trace import warm_profiler
            with run.phase("profiler"):
                warm_profiler(run.torch)
        run.log(setup_line(run))
        self.before = self.server.counters()
        now = time.perf_counter()
        self.setup_s = now - run.t_start
        if run.trace and run.device == "cuda":
            self.span = min(self.TRACE_S, run.seconds)
            self.trace_from = now + (run.seconds - self.span) / 2

    def tick(self, now: float) -> None:
        if self.trace_from is None or self.traced and self.traced[1]:
            return
        if self.trace is None and now >= self.trace_from:
            from portbench.yardstick.trace import DeviceTrace
            self.trace = DeviceTrace(self.run.torch)
            self.trace.__enter__()
            self.run.spans.clear()
            self.traced = (time.perf_counter(), None)
            self.trace_to = self.traced[0] + self.span
        elif self.trace is not None and now >= self.trace_to:
            self._stop()

    def _stop(self) -> None:
        self.trace.close_window()
        self.trace.__exit__(None, None, None)
        self.traced = (self.traced[0], time.perf_counter())

    def close(self) -> None:
        self.after = self.server.counters()
        if self.trace is not None and not self.traced[1]:
            self._stop()

    def record(self, system, out, device, checks, request_bytes,
               counted_requests) -> "RunRecord":
        """``request_bytes(i)``: the Roaring bytes request ``i`` reads and
        returns; the record's ``window_bytes()`` sums it over the requests
        completed inside the traced part of the window."""
        run = self.run
        counters = {k: v - self.before.get(k, 0)
                    for k, v in self.after.items()}
        launches = {k[len("launches."):]: v for k, v in counters.items()
                    if k.startswith("launches.")}
        window_s = out.t_close - out.t_open
        run.log(f"window: {window_s:.3f} s, {len(out.latency_s)} requests "
                f"completed in it of {out.submitted} submitted; counters "
                f"{counters}")
        summary, t = None, time.perf_counter()
        if self.trace is not None:
            summary = self.trace.summary(run.spans)
            run.log(f"trace: {self.traced[1] - self.traced[0]:.3f} s traced, "
                    f"{summary.n_events if summary else 0} device events "
                    f"reduced in {time.perf_counter() - t:.1f} s")
        traced = self.traced

        def window_bytes():
            return sum(request_bytes(i) for i, at in out.done_at.items()
                       if traced and traced[0] <= at <= traced[1])

        return RunRecord(
            system=system, device=device, setup=dict(run.setup),
            setup_s=self.setup_s, window_s=window_s,
            latencies_s=out.window_latencies(), attempted=out.submitted,
            failed=sum(1 for i in range(out.submitted)
                       if i not in out.answers),
            counters=counters, launches=launches, trace=summary,
            window_bytes=window_bytes, checks=checks,
            counted_requests=counted_requests)


def device_info(run) -> dict:
    """The ``device`` of the result line; the peak is read now."""
    torch = run.torch
    if run.device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": None}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": torch.cuda.max_memory_allocated()}


def setup_line(run) -> str:
    """The set-up phases so far, and the set-up time to now."""
    total = time.perf_counter() - run.t_start
    return ("setup: " + ", ".join(f"{k} {v:.3f} s"
                                  for k, v in run.setup.items())
            + f"; setup_s {total:.3f} s")


def run_workload(root, name: str, seed: int, seconds: float, trace: bool,
                 *, device: str = "cuda", t_start: Optional[float] = None,
                 server=None, log=print):
    """Run cell ``name`` once. -> (result dict, lines for the end of
    standard error). ``server`` replaces the program (a control or a
    broken program in the tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    t_entry = time.perf_counter()
    root = Path(root)
    bench = load_benchmark(root)
    cell, cfg_entry = find_cell(bench, name)
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads(
        (root / BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text())
    metrics = cell_metrics(bench, name, trace)
    run = Run(root, config, traffic, seed, seconds, trace, device, t_start,
              server=server, log=log)
    run.setup["start"] = t_entry - t_start     # interpreter, torch, the card
    with run.phase("import"):
        import torch
        run.torch = torch
    system = importlib.import_module(f"portbench.systems.{config['system']}")
    rec = system.run(run)
    values = {}
    for m in metrics:
        v = load_reader(root, m["name"])(rec)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return result_line(rec, values, trace), judge.check_lines(rec.checks)


def result_line(rec: RunRecord, values: dict, trace: bool) -> dict:
    device = dict(rec.device)
    if trace:
        device["busy_s"] = rec.trace.busy_s if rec.trace else None
        device["window_s"] = rec.trace.window_s if rec.trace else None
    out = {"correct": judge.is_correct(rec.checks),
           "attempted": rec.attempted, "failed": rec.failed,
           "metrics": values, "device": device,
           "setup_phases_s": rec.setup}
    if trace and rec.trace:
        out["breakdown"] = {"device_ops": rec.trace.device_ops,
                            "idle_gaps": rec.trace.idle_gaps}
    out["answers"] = {"checked": rec.checks["checked"],
                      "never_came": rec.checks["never_came"]}
    out["checks"] = {k: {"value": rec.checks[k], "limit": lim}
                     for k, lim in judge.LIMITS.items()}
    return out
