#!/usr/bin/env python3
"""A/B of the kind-dispatch kernels of two checkouts on one NVIDIA card.

    python3 tools/dispatch_ab.py OTHER_CHECKOUT [--seed S]

Builds this checkout's kernel library, and OTHER_CHECKOUT's
``src/repro_torch/kernels/roaring/csrc/intersect_dispatch.cu`` alone into a
library of its own (with its own ``roaring_common.cuh`` and this checkout's
generated dispatch table). Then it captures the launches with the most
live work that the search path makes (``chip_smoke.capture_inputs``: the
per-op AND combine with hits rows, and the card-only top-k scoring) and the
three ``sum_`` launches of the SSB store at SF 10, holds both kernels
against the plain version bit for bit on each, and times each launch
through both in turns (other, this, this, other) with ``chip_smoke``'s
card-opened timer (``time_ms``, warm caches).

OTHER_CHECKOUT's library must export ``roaring_intersect_dispatch(a, b,
meta, hits, card, n_rows, b_rows, stream)`` with a nullable ``hits`` (one
kernel for both entries, as before the card-only kernel had an entry of
its own). The last line is a JSON object of the readings in ms.
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


def other_library(other: Path, table: str, tmp: Path) -> ctypes.CDLL:
    """OTHER_CHECKOUT's dispatch source compiled alone, with the build's
    flags."""
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc
    (tmp / "and_table.inc").write_text(table)
    lib = tmp / "libother.so"
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-I", str(other / CSRC),
                    "-I", str(tmp), "-o", str(lib),
                    str(other / CSRC / "intersect_dispatch.cu")], check=True)
    handle = ctypes.CDLL(str(lib))
    handle.roaring_intersect_dispatch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    handle.roaring_intersect_dispatch.restype = ctypes.c_int
    return handle


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="the other checkout's root")
    ap.add_argument("--seed", type=int, default=1402)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("dispatch_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as CS
    import repro_torch.obs as obs
    from repro_torch import search as S
    from repro_torch import store as ST
    from repro_torch.kernels.build import build
    from repro_torch.kernels.roaring import kernel as K
    from repro_torch.kernels.roaring import ref

    CS.log(CS.card_line())
    build()
    CS.timer_self_test(torch)
    tmp = Path(tempfile.mkdtemp())
    other = other_library(args.other.resolve(), K.and_table_source(), tmp)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None else None)

    def other_call(a, b, meta, hits):
        card = torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def call():
            err = other.roaring_intersect_dispatch(
                ptr(a), ptr(b), ptr(meta), ptr(hits), ptr(card), a.shape[0],
                b.shape[0], stream)
            if err:
                raise RuntimeError(f"the other kernel failed: error {err}")
        return call, card

    readings = {}

    def ab(tag, a, b, meta, want, this_call, iters):
        hits = torch.empty_like(a) if len(want) == 2 else None
        call, card = other_call(a, b, meta, hits)
        call()
        got = {"other": (hits, card) if hits is not None else (card,),
               "this": this_call()}
        for name, out in got.items():
            CS._max_err(torch, tuple(x for x in out if x is not None), want)
        ms = [CS.time_ms(torch, fn, iters)
              for fn in (call, this_call, this_call, call)]
        readings[tag] = {"other": (ms[0] + ms[3]) / 2,
                         "this": (ms[1] + ms[2]) / 2, "turns": ms}
        CS.log(f"{tag}: other {readings[tag]['other']:.5f} ms, this "
               f"{readings[tag]['this']:.5f} ms (turns other, this, this, "
               f"other: {', '.join(f'{x:.5f}' for x in ms)}); both "
               f"bit-identical to the plain version ({CS.card_line()})")

    _, index, terms = CS.main_path(torch, S, K, obs, CS.N_TERMS, args.seed)
    captured = CS.capture_inputs(torch, S, K, index, terms, args.seed)
    _, (a, b, meta), _ = captured["intersect_dispatch"]
    ab(f"per-op AND combine, {a.shape[0]} pairs with hits", a, b, meta,
       ref.intersect_dispatch_ref(a, b, meta),
       lambda: K.intersect_dispatch_cuda(a, b, meta), 20)
    _, (a, q, meta), kw = captured["intersect_dispatch_stacked"]
    ab(f"top-k scoring, {a.shape[0] // q.shape[0]} x {q.shape[0]} card only",
       a, q, meta, (CS._plain_card_only(torch, ref, a, q, meta),),
       lambda: K.intersect_dispatch_cuda(a, q, meta, **kw), 10)
    del index, captured, a, b, q, meta
    torch.cuda.empty_cache()

    records = CS.ssb_lineorder(CS.SSB_SF, args.seed)
    store = ST.BitmapStore.build(records, bsi=CS.SSB_BSI)
    sums, launch = [], K.intersect_dispatch_cuda

    def capture(a, b, meta, **kw):
        if not kw.get("want_hits", True):
            sums.append((a, b, meta, kw))
        return launch(a, b, meta, **kw)
    K.intersect_dispatch_cuda = capture
    try:
        for name, (pred, _) in CS.ssb_queries(ST).items():
            store.sum_("lo_extendedprice", pred)
    finally:
        K.intersect_dispatch_cuda = launch
    for name, (a, q, meta, kw) in zip(CS.ssb_queries(ST), sums):
        ab(f"store sum_ {name}, {a.shape[0] // q.shape[0]} x {q.shape[0]} "
           "card only", a, q, meta,
           (CS._plain_card_only(torch, ref, a, q, meta),),
           lambda: K.intersect_dispatch_cuda(a, q, meta, **kw), 20)
    print(json.dumps(readings), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
