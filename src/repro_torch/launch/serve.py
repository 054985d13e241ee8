"""Serving driver: batched requests against the Roaring-paged KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx-132b \
        --reduced --device cpu

``--arch`` takes every architecture of the registry; the paged engine
serves the attention-only ones (every pattern but jamba's Mamba hybrid and
RWKV6, which decode over state caches with ``models.transformer.
decode_step``) and raises for the others, as the reference's engine does.
Runs on the card unless ``--device cpu`` is given. Weights are random,
drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import _device
from repro_torch.configs import get_config, list_archs
from repro_torch.models import transformer as T
from repro_torch.serve import Request, ServeEngine


def make_requests(cfg, n: int, max_new: int, seed: int = 0):
    """``n`` requests with prompts of 4-11 random tokens."""
    rnp = np.random.default_rng(seed)
    return [Request(req_id=i,
                    prompt=rnp.integers(1, cfg.vocab, rnp.integers(4, 12)),
                    max_new_tokens=max_new)
            for i in range(n)]


def serve(eng: ServeEngine, reqs, max_steps: int = 1_000_000):
    """Submit ``reqs`` and step the engine until every one is done; returns
    (seconds, peak page utilization)."""
    sync = (torch.cuda.synchronize if eng.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    peak_util, steps = 0.0, 0
    while eng.queue or eng.active:
        eng.step()
        steps += 1
        peak_util = max(peak_util, eng.utilization())
        if steps > max_steps:
            raise RuntimeError("serve loop did not converge")
    sync()
    return time.perf_counter() - t0, peak_util


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm-1.6b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--n-pages", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = _device.resolve(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    params = T.init_lm(cfg, args.seed, device=device)
    eng = ServeEngine(cfg, params, max_batch=args.max_batch,
                      n_pages=args.n_pages, page_size=args.page_size,
                      max_pages_per_seq=64, device=device)
    reqs = make_requests(cfg, args.requests, args.max_new, args.seed)
    dt, peak_util = serve(eng, reqs)
    total_new = sum(len(r.generated) for r in reqs)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"served {len(reqs)} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new/dt:.1f} tok/s, {eng.steps_run} steps) on {where}, "
          f"peak page util {peak_util:.2%}, final util "
          f"{eng.utilization():.2%}")
    for r in reqs[:3]:
        print(f"  req {r.req_id}: prompt {r.prompt.tolist()} -> {r.generated}")


if __name__ == "__main__":
    main()
