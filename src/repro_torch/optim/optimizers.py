"""Optimizers, written from the reference's formulas.

  * ``adamw`` — AdamW with decoupled weight decay.

The reference's ``adafactor`` and ``adamw8bit`` wait for a later slice
(ROADMAP queue 1).

One protocol, as in the reference, except that the update happens in
place (the reference returns new trees; a functional update of gemma2-2b's
10.5 GB of f32 parameters and 21 GB of moments would need another 21 GB):

    init(params)                          -> opt_state
    update(grads, state, params, step)    -> state

``update`` overwrites the moments in ``state`` and subtracts the update
from each parameter, with every product in f32 as the reference computes
it. It runs under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch import _tree


@dataclasses.dataclass(frozen=True)
class OptimizerDef:
    init: Callable
    update: Callable          # (grads, state, params, step) -> state
    name: str = "opt"


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_ratio * base_lr`` at ``total``; f32 arithmetic as in the
    reference. Returns ``lr(step) -> float``."""
    f32 = np.float32

    def lr(step):
        step = f32(step)
        warm = step / f32(max(1.0, warmup))
        prog = np.clip((step - f32(warmup)) / f32(max(1.0, total - warmup)),
                       f32(0), f32(1))
        cos = f32(min_ratio) + f32(1 - min_ratio) * f32(0.5) * (
            f32(1) + np.cos(f32(math.pi) * prog))
        return float(f32(base_lr) * (warm if step < warmup else cos))
    return lr


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient (in place, as f32) so that their global L2 norm
    is at most ``max_norm``. Returns ``(grads, norm)``: the same tree, now
    f32, and the norm before clipping as a 0-d f32 tensor (no host sync)."""
    flat = _tree.leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in flat))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    out = []
    with torch.no_grad():
        for g in flat:
            g = g if g.dtype == torch.float32 else g.float()
            out.append(g.mul_(scale))
    return _tree.unflatten(grads, out), gn


def adamw(lr, b1=0.9, b2=0.95, eps=1e-8, wd=0.1) -> OptimizerDef:
    lr_fn = lr if callable(lr) else (lambda _: lr)
    f32 = np.float32

    def init(params):
        z = _tree.tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return {"m": z, "v": _tree.tree_map(torch.zeros_like, z)}

    def update(grads, state, params, step):
        t = f32(int(step) + 1)
        lr_t = float(f32(lr_fn(int(step))))
        bc1 = float(f32(1) - f32(b1) ** t)
        bc2 = float(f32(1) - f32(b2) ** t)
        with torch.no_grad():
            for g, m, v, p in zip(*(_tree.leaves(x) for x in (
                    grads, state["m"], state["v"], params))):
                g = g.float()
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                # u = lr * (mhat / (sqrt(vhat) + eps) + wd * p)
                u = torch.div(m, bc1).div_(torch.div(v, bc2).sqrt_().add_(eps))
                u.add_(p.float(), alpha=wd).mul_(lr_t)
                p.sub_(u.to(p.dtype))
        return state

    return OptimizerDef(init, update, "adamw")
