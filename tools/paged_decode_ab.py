#!/usr/bin/env python3
"""A/B of the paged decode kernel of two checkouts on one NVIDIA card.

    python3 tools/paged_decode_ab.py OTHER_CHECKOUT [--seed S]

Builds OTHER_CHECKOUT's ``src/repro_torch/kernels/sparse_attn/csrc/
paged_decode.cu`` into a library of its own and this checkout's into
another (one ``nvcc`` each, both started together, with the build's
flags), and binds each library to its own checkout's wrapper
(``kernel.py`` of the same tree), so each side launches with its own split
rules. Then, on each of these inputs (bf16):

* the registry's paged heads (KVH, G, D) at ``decode_32k``, the batch cut
  from 128 to 32, one layer: 32,768 positions a sequence in pages of 16
  with random page lists, made as ``chip_smoke.decode_32k`` makes them, each
  with its config's attention softcap;
* gemma2-2b's long_500k launch: B 1, KVH 4, G 2, D 256, 524,288 positions
  in pages of 16 with a random page list, softcap 50 (``chip_smoke``'s
  long_500k phase runs the kernel at this shape over the realized cell's
  cache);
* gemma2-2b's serving launch (``chip_smoke``'s serve path's largest): B 4,
  KVH 4, G 2, D 256, pages of 16, 320 pages a sequence, lengths [4216, 19,
  20, 24], softcap 50, over a pool of 1,024 pages;
* dbrx-132b's serving launch: B 4, KVH 8, G 6, D 128, pages of 16, 4 pages
  a sequence, over a pool of 64 pages (``chip_smoke.DBRX_ENGINE``), the
  lengths of its first four requests (``launch.serve.make_requests``) at
  their last step,

it holds both kernels against ``paged_decode_ref`` within ``chip_smoke``'s
tolerance (``paged_error``: each output vector within ``LONG_PAGED_ULPS``
bf16 ulps of its largest element), calls each ``chip_smoke.WARM_CALLS`` times, and times them
in turns (other, this, this, other) with ``chip_smoke.time_cold_ms`` (the
L2 cache overwritten before each call).
The last line is a JSON object of the readings in ms, with each input's
bound.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SRC = "src/repro_torch/kernels/sparse_attn"


def build_libraries(roots: dict, tmp: Path) -> dict:
    """{tag: checkout root} -> {tag: path of a library built from that
    checkout's ``paged_decode.cu`` alone}; the builds run together."""
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc
    procs = {tag: subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp / f"lib_{tag}.so"),
         str(root / SRC / "csrc" / "paged_decode.cu")])
        for tag, root in roots.items()}
    failed = [tag for tag, p in procs.items() if p.wait()]
    if failed:
        raise RuntimeError(f"paged_decode.cu of {failed} does not build")
    return {tag: tmp / f"lib_{tag}.so" for tag in roots}


class _Lib:
    """A loaded library; the other kernels' entry points, which the wrapper
    declares but this library lacks, are inert stand-ins."""

    def __init__(self, cdll: ctypes.CDLL):
        self._cdll = cdll

    def __getattr__(self, name):
        try:
            return getattr(self._cdll, name)
        except AttributeError:
            return types.SimpleNamespace()


def load_wrapper(root: Path, lib: Path, tag: str):
    """``root``'s ``sparse_attn/kernel.py`` as a module whose kernel
    library is ``lib``."""
    handle = _Lib(ctypes.CDLL(str(lib)))
    pkg = f"_paged_decode_ab_{tag}"
    for name in (pkg, f"{pkg}.sparse_attn"):
        sys.modules[name] = types.ModuleType(name)
        sys.modules[name].__path__ = []
    build = types.ModuleType(f"{pkg}.build")
    build.library = lambda: handle

    def raise_on(err, what):
        if err:
            raise RuntimeError(f"{what} ({tag}) launch failed: CUDA error "
                               f"{err}")
    build.raise_on = raise_on
    sys.modules[build.__name__] = build
    sys.modules[pkg].build = build
    spec = importlib.util.spec_from_file_location(
        f"{pkg}.sparse_attn.kernel", root / SRC / "kernel.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def decode_32k_input(torch, gen, KVH, G, D, Bc=32, L=32_768, ps=16):
    """``chip_smoke.decode_32k``'s input (``Bc`` sequences of ``L``
    positions on a random permutation of the pool's pages): (q, pools, host
    page lists, counts, lengths, starts)."""
    n_pp = L // ps
    P = Bc * n_pp
    pidx = torch.randperm(P, generator=gen, device="cuda").to(torch.int32)
    kp, vp = (torch.randn((P, ps, KVH, D), generator=gen, device="cuda",
                          dtype=torch.bfloat16) for _ in range(2))
    q = torch.randn((Bc, KVH, G, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    full = np.full((Bc,), L, np.int32)
    return (q, kp, vp, pidx.reshape(Bc, n_pp).cpu().numpy(),
            np.full((Bc,), n_pp, np.int32), full, np.zeros_like(full))


def serve_input(torch, gen, rng, KVH, G, D, ps, max_pages, n_pages,
                lengths):
    """A serving launch: each row's pages distinct ids of an ``n_pages``
    pool, the list after ``counts`` repeating page 0."""
    lengths = np.asarray(lengths, np.int32)
    B = len(lengths)
    counts = (-(-lengths // ps)).astype(np.int32)
    ids = rng.permutation(n_pages).astype(np.int32)
    pidx = np.zeros((B, max_pages), np.int32)
    used = 0
    for b in range(B):
        pidx[b, :counts[b]] = ids[used:used + counts[b]]
        used += counts[b]
    kp, vp = (torch.randn((n_pages, ps, KVH, D), generator=gen,
                          device="cuda", dtype=torch.bfloat16)
              for _ in range(2))
    q = torch.randn((B, KVH, G, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    return q, kp, vp, pidx, counts, lengths, np.zeros_like(lengths)


def inputs(torch, seed):
    """(tag, make, softcap, timed calls) of every input, in order; ``make``
    builds the input on the card when called."""
    import chip_smoke as CS
    from repro_torch.configs import get_config, list_archs
    from repro_torch.launch.serve import make_requests
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    heads = {}
    for arch in list_archs():
        c = get_config(arch)
        if all(k.startswith("attn") for k in c.block_kinds()):
            key = (c.n_kv_heads, c.n_heads // c.n_kv_heads, c.hd)
            heads.setdefault(key, [[], c.attn_softcap])[0].append(arch)
    out = [(f"decode_32k {' / '.join(archs)} (KVH {k}, G {g}, D {d})",
            lambda k=k, g=g, d=d: decode_32k_input(torch, gen, k, g, d),
            softcap, 10) for (k, g, d), (archs, softcap) in heads.items()]
    gemma = get_config(CS.SERVE_ARCH)
    out.append(("long_500k gemma2-2b (B 1, KVH 4, G 2, D 256)",
                lambda: decode_32k_input(
                    torch, gen, gemma.n_kv_heads,
                    gemma.n_heads // gemma.n_kv_heads, gemma.hd, Bc=1,
                    L=524_288),
                gemma.attn_softcap, 10))
    out.append(("serve gemma2-2b (B 4, KVH 4, G 2, D 256)",
                lambda: serve_input(
                    torch, gen, rng, gemma.n_kv_heads,
                    gemma.n_heads // gemma.n_kv_heads, gemma.hd,
                    CS.SERVE_ENGINE["page_size"],
                    CS.SERVE_ENGINE["max_pages_per_seq"],
                    CS.SERVE_ENGINE["n_pages"], [4216, 19, 20, 24]),
                gemma.attn_softcap, 50))
    dbrx = get_config(CS.DBRX_ARCH)
    reqs = make_requests(dbrx, CS.DBRX_REQUESTS, CS.SERVE_NEW, seed)
    eng = CS.DBRX_ENGINE
    lengths = [len(r.prompt) + CS.SERVE_NEW - 1
               for r in reqs[:eng["max_batch"]]]
    out.append((f"serve dbrx-132b (B 4, KVH 8, G 6, D 128, lengths "
                f"{lengths})",
                lambda: serve_input(
                    torch, gen, rng, dbrx.n_kv_heads,
                    dbrx.n_heads // dbrx.n_kv_heads, dbrx.hd,
                    eng["page_size"], eng["max_pages_per_seq"],
                    eng["n_pages"], lengths),
                dbrx.attn_softcap, 50))
    return out


def time_turns(torch, wrappers: dict, order, seed) -> dict:
    """Check every wrapper on every input, then time them in ``order``
    (tags; each reading is the mean of a tag's turns)."""
    import chip_smoke as CS
    from repro_torch.kernels.sparse_attn import ref as SR
    flush = torch.empty(2 * CS.L2_BYTES, dtype=torch.uint8, device="cuda")
    readings = {}
    for tag, make, softcap, iters in inputs(torch, seed):
        q, kp, vp, pidx, counts, lengths, starts = make()
        lists = tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                      for a in (pidx, counts, lengths, starts))
        args = (q, kp, vp, *lists)
        want = SR.paged_decode_ref(*args, softcap=softcap)
        err, share = {}, {}
        for name, w in wrappers.items():
            got = w.paged_decode_cuda(*args, softcap=softcap)
            torch.cuda.synchronize()
            err[name], share[name] = CS.paged_error(torch, got, want)
        del want, got
        if max(share.values()) > 1:
            raise AssertionError(f"{tag}: a kernel disagrees with its plain "
                                 f"version: max abs err {err}, share of "
                                 f"the tolerance {share}")
        for w in wrappers.values():
            for _ in range(CS.WARM_CALLS):
                w.paged_decode_cuda(*args, softcap=softcap)
        torch.cuda.synchronize()
        turns = [(name, CS.time_cold_ms(
            torch, lambda w=wrappers[name]: w.paged_decode_cuda(
                *args, softcap=softcap), iters, flush)) for name in order]
        ms = {name: float(np.mean([t for n, t in turns if n == name]))
              for name in wrappers}
        bound, n_live = CS.paged_decode_bound(q, pidx, counts, lengths,
                                              starts, kp.shape[1])
        readings[tag] = {**ms, "turns": [t for _, t in turns],
                         "bound_ms": bound[0], "bound_by": bound[1],
                         "live_positions": n_live, "max_abs_err": err,
                         "tolerance_share": share}
        CS.log(f"{tag}: " + ", ".join(
            f"{name} {v:.4f} ms ({100 * bound[0] / v:.1f} % of the bound)"
            for name, v in ms.items())
            + f"; turns {' / '.join(order)}: "
            + ", ".join(f"{t:.4f}" for _, t in turns)
            + f"; bound {bound[0]:.4f} ms by {bound[1]}; max abs err "
            + ", ".join(f"{k} {v:.3g} ({share[k]:.3g} of its tolerance)"
                        for k, v in err.items())
            + f" ({CS.card_line()})")
        del q, kp, vp, args, lists
        torch.cuda.empty_cache()
    return readings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="the other checkout's root")
    ap.add_argument("--seed", type=int, default=1402)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("paged_decode_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as CS
    CS.log(CS.card_line())
    CS.timer_self_test(torch)
    roots = {"other": args.other.resolve(), "this": ROOT}
    libs = build_libraries(roots, Path(tempfile.mkdtemp()))
    wrappers = {tag: load_wrapper(roots[tag], libs[tag], tag)
                for tag in roots}
    readings = time_turns(torch, wrappers, ("other", "this", "this",
                                            "other"), args.seed)
    print(json.dumps(readings), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
