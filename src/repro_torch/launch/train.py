"""Training launcher: bitmap-indexed data pipeline -> train step ->
fault-tolerant loop with async checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
        --reduced --steps 50 --batch 8 --seq 256 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
        --reduced --steps 50 --batch 8 --seq 256          # on the card

``--arch`` takes every architecture of the registry. As in the reference's
launcher, batches carry tokens and a loss mask only (no vision patches and
no encoder memory) and the optimizer is AdamW. Runs on the card unless
``--device cpu`` is given. Weights are random, drawn from seed 0 as the
reference's are; checkpoints go to ``--ckpt`` (default: a directory under
the system's temporary directory).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import _device
from repro_torch.configs import get_config, list_archs
from repro_torch.data import (BitmapIndex, DataPipeline, PipelineState,
                              SyntheticCorpus)
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.runtime import ResilientTrainer
from repro_torch.train import TrainState, make_train_step


def build_data(cfg, batch: int, seq: int, query: str, seed: int = 0,
               n_docs: int = 5000):
    corpus = SyntheticCorpus(n_docs=n_docs, vocab=cfg.vocab, seed=seed,
                             mean_len=max(64, seq // 4))
    index = BitmapIndex(corpus)
    pipe = DataPipeline(index, PipelineState(query=query, seed=seed),
                        batch=batch, seq_len=seq)
    return pipe


def main(argv=None, *, failure_source=None):
    """Train; returns ``{"state", "losses", "restarts"}``.
    ``failure_source(step)`` (``runtime.simulate_failure``) may raise to
    drill the restart path."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-2b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--query", default="quality>=1&!dedup_dup")
    ap.add_argument("--remat", default="none")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = _device.resolve(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"pattern={cfg.layer_pattern}")
    pipe = build_data(cfg, args.batch, args.seq, args.query)
    print(f"selection: {pipe.selection.size} docs for '{args.query}'")

    params = T.init_lm(cfg, 0, device=device)
    opt = adamw(cosine_schedule(args.lr, warmup=20, total=args.steps))
    state = TrainState(params, opt.init(params), 0)
    step_fn = make_train_step(cfg, opt, remat=args.remat)

    batches = {}

    def batch_at(step):
        # deterministic-in-step batches for exact replay after restart
        while len(batches) <= step:
            toks, mask, _ = pipe.next_batch()
            batches[len(batches)] = {
                "tokens": torch.from_numpy(toks).to(device),
                "mask": torch.from_numpy(mask).to(device)}
        return batches[step]

    losses = []
    t_start = time.time()

    def logging_step(state, batch):
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        s = int(state["step"])
        if s % args.log_every == 0:
            tok_s = args.batch * args.seq * s / max(time.time() - t_start, 1e-9)
            print(f"step {s:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} tok/s {tok_s:,.0f}")
        return state, metrics

    trainer = ResilientTrainer(logging_step, args.ckpt,
                               ckpt_every=args.ckpt_every,
                               failure_source=failure_source)
    state, _ = trainer.run(state, batch_at, n_steps=args.steps)
    print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({args.steps} steps, restarts={trainer.restarts})")
    return {"state": state, "losses": losses, "restarts": trainer.restarts}


if __name__ == "__main__":
    main()
