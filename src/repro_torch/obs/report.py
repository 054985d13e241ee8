"""Telemetry export: machine-readable JSON, a human text report, and the
measured-vs-analytic kernel-launch cross-check.

``collect()`` snapshots the metrics registry (refreshing the fused plan-
cache gauges from ``fused.plan_tape.cache_info()``), the completed span
trees, and the environment (torch and CUDA versions, device, host);
``write_report()`` dumps it as JSON; ``render_text()`` is the
terminal-friendly view (launch counts, kind histograms, span tree).

``launch_crosscheck()`` executes one expression through the engine on both
paths and compares the *measured* launch counters with the analytic model —
one ``fused_tree`` launch for the whole tree on the fused path, and
``index.launch_model``'s dispatch count (AND combines at tree-reduce
granularity; OR/ANDNOT combines are plain torch, not kernel launches) on
the per-op path.
"""

from __future__ import annotations

import json
import os
import platform
import sys
from typing import Any, Dict, Optional

from repro_torch.obs import metrics as _m
from repro_torch.obs import trace as _t

__all__ = ["environment", "collect", "write_report", "render_text",
           "launch_crosscheck"]


def environment() -> dict:
    """Host + accelerator-stack metadata stamped onto every report."""
    info: Dict[str, Any] = {
        "python": sys.version.split()[0],
        "host": platform.node(),
        "platform": platform.platform(),
    }
    try:
        import torch
        info["torch"] = torch.__version__
        info["cuda"] = torch.version.cuda
        info["backend"] = "cuda" if torch.cuda.is_available() else "cpu"
        info["device_count"] = torch.cuda.device_count()
        if torch.cuda.is_available():
            info["device"] = torch.cuda.get_device_name(0)
    except Exception:                         # report must never crash
        pass
    return info


def _refresh_derived_gauges() -> None:
    """Pull pull-model stats (the fused plan cache) into registry gauges so
    snapshots carry them without the planner pushing on every compile."""
    try:
        from repro_torch.kernels.roaring import fused
        ci = fused.plan_tape.cache_info()
        g = _m.registry()
        g.gauge("fused.plan_cache.hits").set(ci.hits)
        g.gauge("fused.plan_cache.misses").set(ci.misses)
        g.gauge("fused.plan_cache.entries").set(ci.currsize)
    except Exception:
        pass


def collect(extra: Optional[dict] = None) -> dict:
    """One JSON-ready report: environment + metrics + span trees (+ any
    caller-provided ``extra`` keys, e.g. the bench harness's per-section
    wall times)."""
    _refresh_derived_gauges()
    rep: dict = {
        "environment": environment(),
        "metrics": _m.registry().snapshot(),
        "spans": [s.to_dict() for s in _t.span_trees()],
    }
    if extra:
        rep.update(extra)
    return rep


def write_report(path: str, extra: Optional[dict] = None) -> dict:
    """``collect()`` -> pretty-printed JSON at ``path``; returns the dict."""
    rep = collect(extra)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rep, f, indent=1, default=str)
    return rep


# -- human text report --------------------------------------------------------

def _span_lines(sp: dict, indent: int, out: list) -> None:
    dur = sp.get("duration_s")
    dur_s = "open" if dur is None else f"{dur * 1e3:.2f} ms"
    attrs = sp.get("attrs") or {}
    attr_s = ("  [" + ", ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
              + "]") if attrs else ""
    flag = " !" if sp.get("status") == "error" else ""
    out.append(f"{'  ' * indent}{sp['name']} ({dur_s}){flag}{attr_s}")
    for ev in sp.get("events", []):
        extra = {k: v for k, v in ev.items() if k not in ("name", "offset_s")}
        ev_s = " ".join(f"{k}={v}" for k, v in sorted(extra.items()))
        out.append(f"{'  ' * (indent + 1)}* {ev['name']} {ev_s}".rstrip())
    for c in sp.get("children", []):
        _span_lines(c, indent + 1, out)


def render_text(report: Optional[dict] = None) -> str:
    """Terminal view of a report: environment, launch counters, kind
    histograms, remaining counters/gauges, and the span trees."""
    rep = report if report is not None else collect()
    env = rep.get("environment", {})
    lines = ["# telemetry report",
             f"environment: torch {env.get('torch', '?')} "
             f"({env.get('backend', '?')}) on {env.get('host', '?')}"]
    counters = rep.get("metrics", {}).get("counters", {})
    launches = {k: v for k, v in counters.items()
                if k.startswith("roaring.launches")}
    kinds = {k: v for k, v in counters.items() if "_kinds" in k}
    other = {k: v for k, v in counters.items()
             if k not in launches and k not in kinds}
    if launches:
        lines.append("## kernel launches")
        lines += [f"  {k:58s} {v}" for k, v in launches.items()]
    if kinds:
        lines.append("## container-kind histograms")
        grouped: Dict[str, list] = {}
        for k, v in kinds.items():
            base, _, lbl = k.partition("{")
            kind = "?"
            for part in lbl.rstrip("}").split(","):
                if part.startswith("kind="):
                    kind = part[5:]
            grouped.setdefault(base, []).append(f"{kind}={v}")
        lines += [f"  {base}: " + " ".join(sorted(parts))
                  for base, parts in sorted(grouped.items())]
    if other:
        lines.append("## counters")
        lines += [f"  {k:58s} {v}" for k, v in other.items()]
    gauges = rep.get("metrics", {}).get("gauges", {})
    if gauges:
        lines.append("## gauges")
        lines += [f"  {k:58s} {v}" for k, v in gauges.items()]
    spans = rep.get("spans", [])
    if spans:
        lines.append("## spans")
        for sp in spans:
            _span_lines(sp, 1, lines)
    return "\n".join(lines)


# -- measured-vs-analytic launch accounting -----------------------------------

def launch_crosscheck(stack, expr, *, backend: Optional[str] = None) -> dict:
    """Execute ``expr`` over ``stack`` on both engine paths and
    compare the *measured* launch counters against the analytic models.

    Fused: the whole tree must cost exactly ``plan_stats(...)
    ["launches_fused"]`` (= 1) ``fused_tree`` launch. Per-op: the
    ``intersect_dispatch`` count must equal ``index.launch_model(expr)
    ["per_op_dispatches"]`` (AND combines at the engine's tree-reduce call
    granularity). Returns both sides plus ``match``; telemetry is enabled
    for the duration (restored after).
    """
    import repro_torch.obs as obs
    from repro_torch import index
    from repro_torch.index import engine as _e
    from repro_torch.kernels.roaring import fused as _f

    model = index.launch_model(expr)
    tree, _ = _e._lower_tree(expr)
    st = _f.plan_stats(_f.plan_tape(tree), int(stack.C))
    reg = _m.registry()
    with obs.telemetry_scope():
        f0 = reg.total("roaring.launches", entry="fused_tree")
        index.execute(stack, expr, fused=True, backend=backend)
        fused_measured = reg.total("roaring.launches",
                                   entry="fused_tree") - f0
        p0 = reg.total("roaring.launches", entry="intersect_dispatch")
        index.execute(stack, expr, backend=backend)
        per_op_measured = reg.total("roaring.launches",
                                    entry="intersect_dispatch") - p0
    return {
        "n_operands": model["n_operands"],
        "fused_measured": int(fused_measured),
        "fused_model": int(st["launches_fused"]),
        "per_op_measured": int(per_op_measured),
        "per_op_model": int(model["per_op_dispatches"]),
        "per_op_combines": int(st["launches_per_op"]),
        "match": (fused_measured == st["launches_fused"]
                  and per_op_measured == model["per_op_dispatches"]),
    }
