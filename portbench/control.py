#!/usr/bin/env python3
"""Run a cell with its control in the program's place, on several seeds.

    python3 portbench/control.py --workload <cell> --seconds <s>
        --seeds <n> [<n> ...]

The control (``yardstick.control``) is the plain reference with one
guarantee of the configuration broken; it answers the cell's own traffic
through the harness's own loop, and the harness's own comparison has to
find it not correct. One line a seed: the numbers compared, each beside
its limit. The benchmark's runs never run this; it sets the upper reading
of each limit (PERF.md). The inputs are drawn on the card when there is
one; the control itself is host NumPy.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import bench  # noqa: E402

CONTROLS = {"store": ("portbench.systems.store", "ControlStore")}


def control_for(root, workload: str):
    import importlib
    b = bench.load_benchmark(root)
    _, cfg = bench.find_cell(b, workload)
    system = json.loads((Path(root) / cfg["file"]).read_text())["system"]
    mod, name = CONTROLS[system]
    return getattr(importlib.import_module(mod), name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    server = control_for(ROOT, args.workload)
    import torch
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        line, _ = bench.run_workload(ROOT, args.workload, seed, args.seconds,
                                     False, device=device, server=server,
                                     log=lambda _: None)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": line["correct"],
                          "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
