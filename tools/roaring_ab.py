#!/usr/bin/env python3
"""A/B of the fused-tree and packed-array kernels of two checkouts on one
NVIDIA card.

    python3 tools/roaring_ab.py OTHER_CHECKOUT [--seed S]

Builds this checkout's kernel library, and OTHER_CHECKOUT's
``src/repro_torch/kernels/roaring/csrc/fused_eval.cu`` and
``container_ops.cu`` into a library of their own (with its own
``roaring_common.cuh``). Then it captures these launches:

* the search path's fused launch with the most live operand rows
  (``chip_smoke.capture_inputs``), and the search service's fused count
  stream end to end (closed-loop QPS with each tree's kernel in turns);
* the fused launch of each of SSB Q1.1-Q1.3 on the SF 10 store;
* the SSB month x week pairs of ``array_intersect``
  (``chip_smoke.month_week_arrays``).

It holds both trees' kernels against the plain version bit for bit on each,
times each launch through both in turns (other, this, this, other) with
``chip_smoke``'s card-opened timer (``time_ms``, warm caches), and times
this checkout's kernel at every launch shape it is built for beside the one
its wrapper picks. On each store launch it also times this checkout's
kernel, at its picked shape, on two cut-down forms of the same launch: the
program replaced by one OR over the distinct operands (the lift, one pass
and the root), and that OR with every operand tagged empty (no operand
read: what a column costs before its data).

OTHER_CHECKOUT's library must export ``roaring_fused_eval(ops, meta, tape,
n_steps, N, C, n_slots, bits, card, gscratch, stream)`` with
``roaring_fused_max_smem_slots()`` (the encoded tape of
``fused.encode_tape``) and ``roaring_array_intersect(a, b, cards, hits,
count, n_rows, stream)``. The last line is a JSON object of the readings in
ms.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = "src/repro_torch/kernels/roaring/csrc"


def other_library(other: Path, tmp: Path) -> ctypes.CDLL:
    """OTHER_CHECKOUT's fused and container sources compiled alone, with
    the build's flags, one ``nvcc`` each, then one link."""
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc
    srcs = ("fused_eval.cu", "container_ops.cu")
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-I", str(other / CSRC),
                               "-c", "-o", str(tmp / f"{src}.o"),
                               str(other / CSRC / src)]) for src in srcs]
    if any(p.wait() for p in procs):
        raise RuntimeError("the other checkout's kernels do not build")
    lib = tmp / "libother.so"
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(lib),
                    *(str(tmp / f"{src}.o") for src in srcs)], check=True)
    handle = ctypes.CDLL(str(lib))
    P = ctypes.c_void_p
    handle.roaring_fused_eval.argtypes = (
        [P, P, P] + [ctypes.c_int] * 4 + [P] * 4)
    handle.roaring_fused_eval.restype = ctypes.c_int
    handle.roaring_fused_max_smem_slots.argtypes = []
    handle.roaring_fused_max_smem_slots.restype = ctypes.c_int
    handle.roaring_array_intersect.argtypes = [P] * 5 + [ctypes.c_longlong, P]
    handle.roaring_array_intersect.restype = ctypes.c_int
    return handle


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="the other checkout's root")
    ap.add_argument("--seed", type=int, default=1402)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("roaring_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as CS
    import repro_torch.obs as obs
    from repro_torch import search as S
    from repro_torch import store as ST
    from repro_torch.core import torch_roaring as tr
    from repro_torch.kernels.build import build
    from repro_torch.kernels.roaring import fused as F
    from repro_torch.kernels.roaring import kernel as K
    from repro_torch.kernels.roaring import ref

    CS.log(CS.card_line())
    build()
    CS.timer_self_test(torch)
    other = other_library(args.other.resolve(), Path(tempfile.mkdtemp()))
    other_slots = other.roaring_fused_max_smem_slots()
    smem = K.fused_smem("cuda")

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None else None)

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def checked(err):
        if err:
            raise RuntimeError(f"the other kernel failed: error {err}")

    def other_fused(o, lm, plan):
        N, C = o.shape[0], o.shape[1]
        tape = F.encode_tape(plan, o.device)
        scratch = None
        if plan.n_slots > other_slots:
            scratch = torch.empty((C * plan.n_slots * 2048,),
                                  dtype=torch.int32, device=o.device)
        bits = torch.empty((C, 4096), dtype=torch.int16, device=o.device)
        card = torch.empty((C,), dtype=torch.int32, device=o.device)

        def call():
            checked(other.roaring_fused_eval(
                ptr(o), ptr(lm), ptr(tape), tape.shape[0], N, C,
                plan.n_slots, ptr(bits), ptr(card), ptr(scratch), stream()))
            return bits, card
        return call

    def other_array(a, b, cards):
        hits = torch.empty_like(a)
        count = torch.empty((a.shape[0],), dtype=torch.int32,
                            device=a.device)

        def call():
            checked(other.roaring_array_intersect(
                ptr(a), ptr(b), ptr(cards), ptr(hits), ptr(count),
                a.shape[0], stream()))
            return hits, count
        return call

    readings = {}

    def ab(tag, other_call, this_call, want, shapes, iters):
        for call in (other_call, this_call, *shapes.values()):
            CS._max_err(torch, call(), want)
        ms = [CS.time_ms(torch, fn, iters)
              for fn in (other_call, this_call, this_call, other_call)]
        by_shape = {str(k): CS.time_ms(torch, fn, iters)
                    for k, fn in shapes.items()}
        readings[tag] = {"other": (ms[0] + ms[3]) / 2,
                         "this": (ms[1] + ms[2]) / 2, "turns": ms,
                         "this_by_shape": by_shape}
        CS.log(f"{tag}: other {readings[tag]['other']:.5f} ms, this "
               f"{readings[tag]['this']:.5f} ms (turns other, this, this, "
               f"other: {', '.join(f'{x:.5f}' for x in ms)})"
               + "".join(f"; this at {k} {v:.5f}"
                         for k, v in by_shape.items())
               + f"; all bit-identical to the plain version "
               f"({CS.card_line()})")

    def ab_fused(tag, o, lm, plan, iters):
        lifts = len(F.kernel_program(plan)[0])
        pick = K.fused_launch_shape(lifts, plan.n_slots, *smem)
        shapes = {s: (lambda s=s: K.fused_eval_cuda(o, lm, plan, shape=s))
                  for s in K.fused_shapes(lifts, plan.n_slots, smem[0])
                  if s != pick}
        bound = CS.fused_bound(lm.cpu().numpy(), plan.n_ops, o.shape[0],
                               o.shape[1])
        ab(f"{tag}, {o.shape[0]} operands ({lifts} distinct) x {o.shape[1]}"
           f" columns, {plan.n_ops} word ops, picked {pick}, bound "
           f"{bound[0]:.5f} ms by {bound[1]}", other_fused(o, lm, plan),
           lambda: K.fused_eval_cuda(o, lm, plan),
           F.fused_eval_ref(o, lm, plan=plan), shapes, iters)

    _, index, terms = CS.main_path(torch, S, K, obs, CS.N_TERMS,
                                   args.seed)
    captured = CS.capture_inputs(torch, S, K, index, terms, args.seed)
    _, (o, lm, plan), _ = captured["fused_tree"]
    ab_fused("search fused launch", o, lm, plan, 20)
    queries = CS.make_queries(S, terms, 1024, args.seed)
    this_launch = K.fused_eval_cuda

    def count_qps(launch):
        K.fused_eval_cuda = launch
        try:
            svc = S.SearchService(index, max_batch=16, cache_slots=256,
                                  fused=True)
            S.run_closed_loop(svc, queries, concurrency=64,
                              mode="count")
            torch.cuda.synchronize()
            return S.run_closed_loop(svc, queries, concurrency=64,
                                     mode="count").qps
        finally:
            K.fused_eval_cuda = this_launch

    def other_launch(ops_, meta, plan_, **kw):
        return other_fused(ops_, meta, plan_)()
    qps = [count_qps(fn) for fn in (other_launch, this_launch,
                                    this_launch, other_launch)]
    readings["search fused count QPS"] = {
        "other": (qps[0] + qps[3]) / 2, "this": (qps[1] + qps[2]) / 2,
        "turns": qps}
    CS.log("search fused count, 1024 requests closed loop (64 in "
           "flight), QPS in turns other, this, this, other: "
           + ", ".join(f"{x:.1f}" for x in qps) + f" ({CS.card_line()})")
    del index, captured, o, lm
    torch.cuda.empty_cache()

    records = CS.ssb_lineorder(CS.SSB_SF, args.seed)
    store = ST.BitmapStore.build(records, bsi=CS.SSB_BSI)
    fused, launch = {}, K.fused_eval_cuda

    def capture(o, lm, plan, **kw):
        fused.setdefault(name, (o, lm, plan))
        return launch(o, lm, plan, **kw)
    K.fused_eval_cuda = capture
    try:
        for name, (pred, _) in CS.ssb_queries(ST).items():
            store.count(pred, fused=True)
    finally:
        K.fused_eval_cuda = launch
    for name, (o, lm, plan) in fused.items():
        ab_fused(f"store {name} fused launch", o, lm, plan, 20)
        lifts = F.kernel_program(plan)[0]
        pick = K.fused_launch_shape(len(lifts), plan.n_slots, *smem)
        one_or = F.plan_tape(("or",) + tuple(lifts))
        n_fields = 3 * o.shape[0] * o.shape[1]
        empty = lm.clone()
        empty[:n_fields:3] = 0
        parts = {"program": (plan, lm), "one OR": (one_or, lm),
                 "one OR, no operand read": (one_or, empty)}
        ms = {k: CS.time_ms(torch, lambda p=p, m=m: K.fused_eval_cuda(
            o, m, p, shape=pick), 20) for k, (p, m) in parts.items()}
        readings[f"store {name} parts"] = ms
        CS.log(f"store {name} at {pick}: " + ", ".join(
            f"{k} {v:.5f} ms" for k, v in ms.items())
            + f" ({CS.card_line()})")

    ia, ib, cards, _, _ = CS.month_week_arrays(torch, tr, store)
    ab(f"array_intersect, {ia.shape[0]} month x week pairs",
       other_array(ia, ib, cards),
       lambda: K.array_intersect_cuda(ia, ib, cards),
       ref.array_intersect_ref(ia, ib, cards), {}, 10)
    print(json.dumps(readings), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
