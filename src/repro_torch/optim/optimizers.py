"""Optimizers, written from the reference's formulas.

  * ``adamw``     — AdamW with decoupled weight decay.
  * ``adafactor`` — factored second moments (Shazeer & Stern): a [n, m]
    tile keeps n + m floats of state instead of n * m; the reference's
    choice above 50 B parameters (``launch.specs.pick_optimizer``).
  * ``adamw8bit`` — AdamW whose m and v are kept as int8 codes with one
    f32 absmax a block of 256 values (power-law codes).

One protocol, as in the reference, except that the update happens in
place (the reference returns new trees; a functional update of gemma2-2b's
10.5 GB of f32 parameters and 21 GB of moments would need another 21 GB):

    init(params)                          -> opt_state
    update(grads, state, params, step)    -> state

``update`` overwrites the state and subtracts the update from each
parameter, with every product in f32 as the reference computes it; the
update is rounded to the parameter's dtype before it is subtracted, as the
reference's is. It runs under ``torch.no_grad()``. ``adafactor`` computes
its update in the f32 gradients' own storage, so they are spent after the
call (the trainer drops them).
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


# =============================================================================
# Adafactor (factored second moments)
# =============================================================================

def adafactor_factored(shape, min_dim_factored: int = 8) -> bool:
    """The reference's ``_factored`` rule: factor a leaf over its trailing
    two dims when both are at least ``min_dim_factored`` and the tile holds
    at least 4,096 values (a stacked ``[layers, d, H, hd]`` weight factors
    per ``H x hd`` tile)."""
    return (len(shape) >= 2 and shape[-1] >= min_dim_factored
            and shape[-2] >= min_dim_factored
            and shape[-1] * shape[-2] >= 4096)


def adafactor(lr, eps=1e-30, clip_thresh=1.0, decay_pow=0.8,
              min_dim_factored=8) -> OptimizerDef:
    lr_fn = lr if callable(lr) else (lambda _: lr)
    f32 = np.float32

    def init(params):
        def one(p):
            kw = dict(dtype=torch.float32, device=p.device)
            if adafactor_factored(p.shape, min_dim_factored):
                return {"vr": torch.zeros(p.shape[:-1], **kw),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **kw)}
            return {"v": torch.zeros(p.shape, **kw)}
        return _tree.tree_map(one, params)

    def update(grads, state, params, step):
        t = f32(int(step) + 1)
        beta2 = f32(1) - t ** f32(-decay_pow)
        lr_t = float(f32(lr_fn(int(step))))
        keep, new = float(beta2), float(f32(1) - beta2)
        with torch.no_grad():
            for g, p, s in zip(_tree.leaves(grads), _tree.leaves(params),
                               _tree.leaf_nodes(params, state)):
                u = g if g.dtype == torch.float32 else g.float()
                g2 = torch.square(u).add_(eps)
                if "vr" in s:
                    vr = s["vr"].mul_(keep).add_(g2.mean(-1), alpha=new)
                    vc = s["vc"].mul_(keep).add_(g2.mean(-2), alpha=new)
                    del g2
                    denom = torch.clamp(vr.mean(-1, keepdim=True), min=eps)
                    # u = g * rsqrt(vr vc / denom + eps), in g's storage
                    v_est = torch.mul(vr[..., None], vc[..., None, :])
                    u.mul_(v_est.div_(denom[..., None]).add_(eps).rsqrt_())
                    del v_est
                else:
                    v = s["v"].mul_(keep).add_(g2, alpha=new)
                    del g2
                    u.mul_(torch.add(v, eps).rsqrt_())
                # update clipping: the update's RMS at most clip_thresh
                flat = u.reshape(-1)
                rms = torch.sqrt(torch.dot(flat, flat) / flat.numel() + eps)
                u.div_(torch.clamp(rms / clip_thresh, min=1.0)).mul_(lr_t)
                p.sub_(u.to(p.dtype))
        return state

    return OptimizerDef(init, update, "adafactor")


# =============================================================================
# 8-bit AdamW (block-wise quantized m and v)
# =============================================================================

_QBLOCK = 256


def _quantize(x: torch.Tensor, power: float = 2.0):
    """Block-wise absmax int8 codes with a power-law map, as the reference:
    ``q = round(127 * (|x| / absmax) ** (1 / power)) * sign(x)`` (ties to
    even, as ``jnp.round``), clipped to [-127, 127]; x holds a multiple of
    ``_QBLOCK`` values. Returns (int8 codes [n], f32 absmax [n / 256])."""
    xb = x.reshape(-1, _QBLOCK)
    scale = torch.clamp(xb.abs().amax(-1, keepdim=True), min=1e-12)
    frac = xb.abs() / scale
    q = torch.round(127.0 * frac ** (1.0 / power)) * torch.sign(xb)
    q = torch.clamp(q, -127, 127).to(torch.int8)
    return q.reshape(-1), scale[:, 0]


def _dequantize(q: torch.Tensor, scale: torch.Tensor, power: float = 2.0):
    qb = q.reshape(-1, _QBLOCK).float()
    frac = (qb.abs() / 127.0) ** power
    return (torch.sign(qb) * frac * scale[:, None]).reshape(-1)


def adamw8bit(lr, b1=0.9, b2=0.95, eps=1e-8, wd=0.1) -> OptimizerDef:
    lr_fn = lr if callable(lr) else (lambda _: lr)
    f32 = np.float32

    def _pad(n):
        return (n + _QBLOCK - 1) // _QBLOCK * _QBLOCK

    def init(params):
        def one(p):
            n, dev = _pad(p.numel()), p.device
            return {"mq": torch.zeros(n, dtype=torch.int8, device=dev),
                    "ms": torch.zeros(n // _QBLOCK, dtype=torch.float32,
                                      device=dev),
                    "vq": torch.zeros(n, dtype=torch.int8, device=dev),
                    "vs": torch.zeros(n // _QBLOCK, dtype=torch.float32,
                                      device=dev)}
        return _tree.tree_map(one, params)

    def update(grads, state, params, step):
        t = f32(int(step) + 1)
        lr_t = f32(lr_fn(int(step)))
        bc1 = float(f32(1) - f32(b1) ** t)
        bc2 = float(f32(1) - f32(b2) ** t)
        lr_wd = float(lr_t * f32(wd))
        with torch.no_grad():
            for g, p, s in zip(_tree.leaves(grads), _tree.leaves(params),
                               _tree.leaf_nodes(params, state)):
                n = s["mq"].numel()
                gf = torch.nn.functional.pad(g.float().reshape(-1),
                                             (0, n - p.numel()))
                m = _dequantize(s["mq"], s["ms"], power=2.0)
                v = _dequantize(s["vq"], s["vs"], power=4.0)
                m = m * b1 + gf * (1 - b1)
                v = v * b2 + gf * (1 - b2) * gf
                # u = lr * mhat / (sqrt(vhat) + eps) + lr * wd * p
                u = torch.div(m, bc1).div_(torch.div(v, bc2).sqrt_()
                                           .add_(eps)).mul_(float(lr_t))
                u = u[:p.numel()].reshape(p.shape).add_(p.float(),
                                                        alpha=lr_wd)
                for (kq, ks), x, pw in ((("mq", "ms"), m, 2.0),
                                        (("vq", "vs"), v, 4.0)):
                    q, sc = _quantize(x, power=pw)
                    s[kq].copy_(q)
                    s[ks].copy_(sc)
                p.sub_(u.to(p.dtype))
        return state

    return OptimizerDef(init, update, "adamw8bit")
