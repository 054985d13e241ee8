"""A configuration, a traffic mix, a cell and a metric are added as new
files and new entries alone, and the harness finds and reports them."""

import json

from conftest import run_tiny


def test_added_files_make_a_new_cell_and_metric(tiny_root, tmp_path):
    import shutil
    root = tmp_path / "root"
    shutil.copytree(tiny_root, root, symlinks=True)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    cfg = json.loads((root / "portbench/configs/tiny-store.json")
                     .read_text())
    cfg.update(scale_factor=0.01)
    (root / "portbench/configs/added-cfg.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "portbench/traffic/q1-count.json").read_text())
    tr.update(warmup_rounds=1, queries=[
        {"name": "years", "where": [["range", "lo_year", 1993, 1995],
                                    ["eq", "lo_discount", 4]]},
        {"name": "cheap", "where": [["range", "lo_quantity", None, 10]]}])
    (root / "portbench/traffic/added-mix.json").write_text(json.dumps(tr))
    (root / "portbench/metrics/added.requests.py").write_text(
        "def read(run):\n    return run.n_done\n")
    (root / "portbench/metrics/added.never.py").write_text(
        "def read(run):\n    return None\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "added-cfg", "source": "a test",
                         "file": "portbench/configs/added-cfg.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "added-cell", "config": "added-cfg",
                           "traffic": "added-mix", "chips": 1,
                           "why": "a test"})
    for name in ("added.requests", "added.never"):
        b["per_layer"].append({"name": name, "unit": "requests",
                               "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "qps", "workloads": ["added-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    line, checks = run_tiny(root, "added-cell", trace=True)
    assert line["correct"], checks
    assert line["metrics"]["added.requests"]["value"] > 0
    assert "added.never" not in line["metrics"]
    line, _ = run_tiny(root, "added-cell")
    assert set(line["metrics"]) == {"qps", "p95_ms", "setup_s"}
    for p, data in before.items():               # nothing was edited
        assert p.read_bytes() == data
