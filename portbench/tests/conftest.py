"""Tiny cells on the CPU: a checkout root in a temporary directory with
its own BENCHMARK.json and data files, the port's ``src`` linked in."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_STORE = {"scale_factor": 0.02}
CELLS = (("t-count", "q1-count"), ("t-revenue", "q1-revenue"))


def make_root(tmp: Path) -> Path:
    """A checkout root holding the benchmark's data files, BENCHMARK.json
    with a tiny store configuration and its two cells added, and the
    program."""
    root = tmp / "root"
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(REPO / "portbench" / d, root / "portbench" / d)
    (root / "src").symlink_to(REPO / "src")
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    cfgs = root / "portbench" / "configs"
    c = json.loads((cfgs / "ssb-sf10.json").read_text())
    c.update(TINY_STORE)
    (cfgs / "tiny-store.json").write_text(json.dumps(c))
    b["configs"].append({"name": "tiny-store", "source": "a test",
                         "file": "portbench/configs/tiny-store.json",
                         "reduced": sorted(TINY_STORE), "why": "a test"})
    for cell, traffic in CELLS:
        b["workloads"].append({"name": cell, "config": "tiny-store",
                               "traffic": traffic, "chips": 1,
                               "why": "a test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [cell for cell, _ in CELLS]
    (root / "BENCHMARK.json").write_text(json.dumps(b, indent=1))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("portbench"))


def run_tiny(root, cell, seed=20240601, seconds=1.5, server=None,
             trace=False):
    from portbench import bench
    return bench.run_workload(root, cell, seed, seconds, trace,
                              device="cpu", server=server,
                              log=lambda _: None)
