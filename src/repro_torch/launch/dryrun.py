"""Dry run: build every (architecture x shape x mesh) cell on the ``meta``
device, with no card and no process group, and write what it would take.

The port's counterpart of the reference's ``launch/dryrun.py``, which
lowers and compiles each cell against 512 host placeholder devices. Here
``launch.specs.build_cell`` builds the cell's arguments as ``meta``
tensors with their logical specs, and each cell's record holds:

* the reference's keys (cell, arch, shape, mesh, chips, ok, the cell's
  ``meta``, ``collectives``, ``analytic``, ``roofline``; ``error`` and
  ``traceback`` for a cell that failed). ``lower_s`` is the time to build
  the cell; ``compile_s``, ``cost_analysis`` and the temp / output / code
  sizes of ``memory_analysis`` come from XLA's compiler and have no
  counterpart in an eager program, so they are ``None`` (the record's
  ``no_counterpart`` says so) rather than guessed;
* ``arg_bytes``: the exact bytes of the arguments that one rank holds, by
  group (params, opt, caches, batch; the train step counter with opt);
* ``analytic``: ``models/flops.py``'s FLOPs and HBM bytes;
* ``collectives``: ``launch/collectives.py``'s count from the placements
  (``"source": "placements"``);
* ``roofline``: compute, memory and collective times from the H100's own
  figures (``HARDWARE``), and the dominant term.

Usage:

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --archs all --shapes all --meshes single,multi \\
        --out artifacts/dryrun_torch
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import time
import traceback

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import specs as SP
from repro_torch.launch.collectives import cell_collectives
from repro_torch.launch.mesh import production_mesh_sizes
from repro_torch.models import flops as F

# roofline denominators: one NVIDIA H100 SXM5 and its links
HARDWARE = {
    "peak_flops": 989.4e12,   # dense bf16 tensor-core FLOP/s (H100 SXM5 data sheet)
    "hbm_bw": 3.35e12,        # HBM3 bytes/s (H100 SXM5 data sheet)
    "nvlink_bw": 450e9,       # NVLink 4, bytes/s each way, within an 8-GPU node (data sheet: 900 GB/s total)
    "node_bw": 50e9,          # one 400 Gb/s NDR InfiniBand port a GPU, across nodes
    "gpus_per_node": 8,       # HGX H100 8-GPU baseboard
}

# cheap-first ordering: fast feedback, giants last
ARCH_ORDER = [
    "whisper-base", "stablelm-1.6b", "rwkv6-1.6b", "gemma2-2b",
    "stablelm-3b", "starcoder2-15b", "qwen2-vl-72b", "dbrx-132b",
    "llama4-maverick-400b-a17b", "jamba-1.5-large-398b",
]

NO_COUNTERPART = ("compile_s", "cost_analysis",
                  "memory_analysis.output_size_in_bytes",
                  "memory_analysis.temp_size_in_bytes",
                  "memory_analysis.generated_code_size_in_bytes")


def axis_bandwidth(sizes: dict, axes) -> float:
    """Bytes/s of a collective over the mesh dimensions ``axes``: ranks sit
    in mesh order (row-major over ``sizes``), ``gpus_per_node`` to a node,
    and a group that spans two nodes runs at the slower link."""
    names = list(sizes)
    dims = [sizes[n] for n in names]
    inner = [n for n in names if n not in axes]
    strides = [math.prod(dims[i + 1:]) for i in range(len(dims))]
    node = HARDWARE["gpus_per_node"]
    for fixed in itertools.product(*(range(sizes[n]) for n in inner)):
        base = sum(c * strides[names.index(n)] for c, n in zip(fixed, inner))
        group = {(base + sum(c * strides[names.index(a)]
                             for c, a in zip(cs, axes))) // node
                 for cs in itertools.product(*(range(sizes[a])
                                               for a in axes))}
        if len(group) > 1:
            return HARDWARE["node_bw"]
    return HARDWARE["nvlink_bw"]


def arg_bytes(kind: str, args, specs, mesh) -> dict:
    """Exact per-rank bytes of a cell's arguments by group."""
    if kind == "train":
        (state, batch), (state_sh, batch_sh) = args, specs
        groups = {"params": (state["params"], state_sh["params"]),
                  "opt": ((state["opt"], state["step"]),
                          (state_sh["opt"], state_sh["step"]))}
    else:
        groups = {"params": (args[0], specs[0])}
        if kind == "decode":
            groups["caches"] = (args[1], specs[1])
        batch, batch_sh = args[-1], specs[-1]
    groups["batch"] = (batch, batch_sh)
    out = {k: SP.rank_bytes(a, s, mesh) for k, (a, s) in groups.items()}
    out["total"] = sum(out.values())
    return out


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             skip_existing: bool = True) -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell_id = f"{arch}__{shape}__{mesh_name}"
    path = os.path.join(out_dir, cell_id + ".json")
    os.makedirs(out_dir, exist_ok=True)
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("ok"):
            print(f"[{cell_id}] cached ok")
            return rec

    mesh = production_mesh_sizes(multi_pod=multi_pod)
    n_chips = math.prod(mesh.values())
    spec = SHAPES[shape]
    record = {"cell": cell_id, "arch": arch, "shape": shape,
              "mesh": dict(mesh), "chips": n_chips, "ok": False}
    try:
        t0 = time.perf_counter()
        _, args, specs, _, meta = SP.build_cell(arch, shape, mesh)
        record["lower_s"] = round(time.perf_counter() - t0, 3)
        record.update(meta)
        cfg = get_config(arch)
        record["arg_bytes"] = arg_bytes(spec.kind, args, specs, mesh)
        record["compile_s"] = None
        record["memory_analysis"] = {
            "argument_size_in_bytes": record["arg_bytes"]["total"],
            "output_size_in_bytes": None, "temp_size_in_bytes": None,
            "generated_code_size_in_bytes": None}
        record["cost_analysis"] = None
        record["no_counterpart"] = list(NO_COUNTERPART)
        print(f"[{cell_id}] arg_bytes per rank: {record['arg_bytes']}",
              flush=True)

        mode = SP._sharding_mode(cfg)
        extra = (SP.VIS_TOKENS if cfg.frontend == "vision" else 0)
        coll = cell_collectives(cfg, spec.kind, args, specs, mesh,
                                seq_len=spec.seq_len,
                                global_batch=spec.global_batch,
                                microbatch=record.get("microbatch"),
                                mode=mode, seq_extra=extra)
        record["collectives"] = coll

        # Roaring active-window decode shrinks the live KV (long_window)
        seq_eff = record.get("long_window", spec.seq_len)
        fc = F.cell_flops(cfg, kind=spec.kind, seq_len=seq_eff,
                          global_batch=spec.global_batch)
        mf = F.model_flops_reference(cfg, kind=spec.kind, seq_len=seq_eff,
                                     global_batch=spec.global_batch)
        hbm = F.cell_hbm_bytes(cfg, kind=spec.kind, seq_len=seq_eff,
                               global_batch=spec.global_batch,
                               optimizer=record.get("optimizer", "adamw"))
        record["analytic"] = {
            "flops_total": fc.total, "flops_matmul": fc.matmul,
            "flops_attention": fc.attention,
            "flops_elementwise": fc.elementwise,
            "model_flops_ref": mf, "hbm_bytes": hbm}

        compute_term = fc.total / (n_chips * HARDWARE["peak_flops"])
        memory_term = hbm / (n_chips * HARDWARE["hbm_bw"])
        collective_term = sum(
            b / axis_bandwidth(mesh, tuple(axes.split("+")))
            for axes, b in coll["per_axes"].items())
        terms = {"compute_s": compute_term, "memory_s": memory_term,
                 "collective_s": collective_term}
        dominant = max(terms, key=terms.get)
        record["roofline"] = {
            **terms, "dominant": dominant,
            "useful_ratio": mf / max(fc.total, 1.0),
            "roofline_fraction": compute_term / max(sum(terms.values()),
                                                    1e-30),
            "hardware": dict(HARDWARE)}
        record["ok"] = True
        print(f"[{cell_id}] roofline: compute={compute_term:.4f}s "
              f"memory={memory_term:.4f}s "
              f"collective={collective_term:.4f}s dominant={dominant}",
              flush=True)
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-3000:]
        print(f"[{cell_id}] FAILED: {record['error']}", flush=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", default="all")
    ap.add_argument("--shapes", default="all")
    ap.add_argument("--meshes", default="single,multi")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--no-skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_ORDER if args.archs == "all" else args.archs.split(",")
    shapes = list(SHAPES) if args.shapes == "all" else args.shapes.split(",")
    meshes = args.meshes.split(",")

    results = []
    for arch in archs:
        for shape in shapes:
            for m in meshes:
                results.append(run_cell(
                    arch, shape, m == "multi", args.out,
                    skip_existing=not args.no_skip_existing))
    ok = sum(1 for r in results if r.get("ok"))
    print(f"\n=== dry-run: {ok}/{len(results)} cells ok ===")
    for r in results:
        if not r.get("ok"):
            print(f"  FAILED {r['cell']}: {r.get('error', '?')}")
    return results


if __name__ == "__main__":
    main()
