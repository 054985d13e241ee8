#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. Set-up phases and the window go to standard
output as they end, then one JSON line, the result: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
under the device profiler. The numbers that decide ``correct`` end
standard error, each beside its limit. Exits non-zero, printing no result,
without as many CUDA cards as the cell asks for, without the program's
``src/`` beside this folder, or when JAX or the JAX package ``repro`` was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import bench  # noqa: E402


def log(line: str) -> None:
    print(line, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell, _ = bench.find_cell(bench.load_benchmark(ROOT), args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"cell {args.workload} needs {cell['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    line, checks = bench.run_workload(
        ROOT, args.workload, args.seed % (1 << 64), args.seconds,
        bool(args.trace), t_start=T_START, log=log)
    bad = bench.forbidden_modules()
    if bad:
        print(f"modules that may not be loaded were loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    for text in checks:
        print(text, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
