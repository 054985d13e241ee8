"""The result line's schema, and the runs that must print none."""

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import run_tiny

REPO = Path(__file__).resolve().parents[2]


def check_line(line, trace, metrics):
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert isinstance(line["correct"], bool)
    assert line["attempted"] >= line["failed"] >= 0
    assert set(line["metrics"]) <= metrics
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"} and math.isfinite(v["value"])
    dev = line["device"]
    for key in ("platform", "kind", "count", "memory_peak_bytes"):
        assert key in dev
    if trace:
        assert "busy_s" in dev and "window_s" in dev
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


@pytest.mark.parametrize("cell", ["t-count", "t-revenue"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(tiny_root, cell, trace):
    from portbench import bench
    b = bench.load_benchmark(tiny_root)
    names = {m["name"] for m in bench.cell_metrics(b, cell, trace)}
    line, checks = run_tiny(tiny_root, cell, trace=trace)
    check_line(line, trace, names)
    if not trace:
        assert {"qps", "p95_ms", "setup_s"} <= set(line["metrics"])
    assert checks[-1].startswith("check wrong")
    assert line["answers"]["checked"] > 0


def test_every_cell_has_its_metrics_files():
    from portbench import bench
    b = bench.load_benchmark(REPO)
    for m in b["end_to_end"] + b["per_layer"]:
        assert (REPO / "portbench/metrics" / f"{m['name']}.py").is_file()
    for c in b["configs"]:
        assert (REPO / c["file"]).is_file()
    for w in b["workloads"]:
        assert (REPO / "portbench/traffic" / f"{w['traffic']}.json").is_file()
        assert bench.cell_metrics(b, w["name"], True)
        assert {"setup_s"} < {m["name"] for m in
                              bench.cell_metrics(b, w["name"], False)}


def test_without_a_card_run_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "ssb-q1-count", "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_there_is_no_run(tmp_path):
    from portbench import bench
    with pytest.raises(ImportError):
        bench.use_program(tmp_path)
