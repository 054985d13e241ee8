"""Train-step builder: remat, microbatching, mixed precision, grad clipping.

Parameters keep ``cfg.param_dtype`` and every layer computes in
``cfg.compute_dtype``, as in the reference. A leaf that the loss does not
reach (whisper's encoder, which the train step never runs, since the batch
carries the encoder's output as ``memory``; the cross-attention without
``memory``) gets a zero gradient, as JAX gives it, so weight decay and
Adafactor still update it. The step updates the train state **in place** (the
optimizer's moments and the parameters; see ``optim``) and returns the same
dict. ``grad_compression={"axis": ..., "ratio": ...}`` replaces the
gradients by their Roaring top-k mean over the declared mesh's ``axis``
dimension (``grad_comp.compressed_crosspod_mean``) before clipping, where
the reference applies it.

Two of the reference's experiment knobs are read once, when
``make_train_step`` builds the step (both unset in baselines):
``REPRO_ACCUM_DTYPE=bf16`` keeps the microbatch gradient sum in bf16 (each
microstep's addition in f32, then rounded), and
``REPRO_GRAD_AR_DTYPE=bf16`` rounds the gradients to bf16 before the
cross-pod mean and the clip (the data-parallel reduction's wire format;
the optimizer's arithmetic stays f32).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch

from repro_torch import _tree
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptimizerDef, clip_by_global_norm


def TrainState(params, opt_state, step) -> dict:
    return {"params": params, "opt": opt_state,
            "step": torch.tensor(int(step), dtype=torch.int32)}


def _device_of(params) -> torch.device:
    return _tree.leaves(params)[0].device


def make_train_step(cfg: ModelConfig, optimizer: OptimizerDef, *,
                    microbatch: Optional[int] = None,
                    remat: str = "none",              # none | full | dots
                    max_grad_norm: float = 1.0,
                    grad_compression: Optional[dict] = None,
                    block_lists=None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    batch: {"tokens": int[B, S+1], "mask": float[B, S+1]} (tensors or numpy
    arrays) — inputs are tokens[:, :-1], labels tokens[:, 1:] — and
    optionally "extra_embeds" ([B, S_m, d], the vision stub's patches) and
    "memory" ([B, S_enc, d], the encoder's output), passed to ``forward``
    and sliced per microbatch as the tokens are. ``block_lists``
    (kv_idx, counts) from ``sparsity.compile_mask`` feed the block-sparse
    attention of global layers when ``cfg.attn_impl == "sparse"``. metrics:
    ``loss`` and ``grad_norm`` (before clipping), 0-d f32 tensors on the
    parameters' device. ``grad_compression`` needs a mesh with its axis
    declared by ``distributed.context.data_axes`` around the step.
    """
    lists_on = {}

    def lists_for(dev):
        if block_lists is None:
            return None
        if dev not in lists_on:
            lists_on[dev] = tuple(torch.as_tensor(a).to(dev, torch.int32)
                                  for a in block_lists)
        return lists_on[dev]

    def loss_fn(params, tokens, labels, mask, extra_embeds, memory):
        logits, aux = T.forward(params, tokens, cfg,
                                block_lists=lists_for(tokens.device),
                                extra_embeds=extra_embeds, memory=memory,
                                remat=remat)
        logits = logits.float()
        # logsumexp form; the label's logit by a gather, which gives the
        # reference's where-and-sum value exactly without a [B, S, V] mask
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, labels.long()[..., None])[..., 0]
        nll = lse - ll
        denom = torch.clamp(mask.sum(), min=1.0)
        return (nll * mask).sum() / denom + 0.01 * aux

    acc_dt = (torch.bfloat16 if os.environ.get("REPRO_ACCUM_DTYPE") == "bf16"
              else torch.float32)
    grad_ar_bf16 = os.environ.get("REPRO_GRAD_AR_DTYPE") == "bf16"

    def grad_fn(flat, params, *inputs):
        loss = loss_fn(params, *inputs)
        return loss.detach(), torch.autograd.grad(
            loss, flat, allow_unused=True, materialize_grads=True)

    def compute_grads(params, batch):
        dev = _device_of(params)
        toks = torch.as_tensor(batch["tokens"]).to(dev)
        msk = torch.as_tensor(batch["mask"]).to(dev, torch.float32)
        extra, memory = (None if batch.get(k) is None
                         else torch.as_tensor(batch[k]).to(dev)
                         for k in ("extra_embeds", "memory"))
        inputs = (toks[:, :-1], toks[:, 1:], msk[:, 1:], extra, memory)
        flat = _tree.leaves(params)
        for p in flat:
            p.requires_grad_(True)
        if microbatch is None:
            loss, grads = grad_fn(flat, params, *inputs)
            return loss, _tree.unflatten(params, list(grads))
        B = toks.shape[0]
        if B % microbatch:
            raise ValueError(f"batch {B} is not a multiple of microbatch "
                             f"{microbatch}")
        n_micro = B // microbatch
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        acc = [torch.zeros_like(p, dtype=acc_dt) for p in flat]
        for i in range(n_micro):
            sl = slice(i * microbatch, (i + 1) * microbatch)
            l, g = grad_fn(flat, params, *(None if x is None else x[sl]
                                           for x in inputs))
            loss = loss + l / n_micro
            for a, gi in zip(acc, g):
                if acc_dt == torch.float32:
                    a.add_(gi.float() / n_micro)
                else:       # the sum in f32, rounded to the accumulator
                    a.copy_(a.float() + gi.float() / n_micro)
        return loss, _tree.unflatten(params, acc)

    def train_step(state, batch):
        loss, grads = compute_grads(state["params"], batch)
        if grad_ar_bf16:
            grads = _tree.tree_map(lambda g: g.to(torch.bfloat16), grads)
        if grad_compression is not None:
            from repro_torch.grad_comp import compressed_crosspod_mean
            grads = compressed_crosspod_mean(
                grads, axis_name=grad_compression.get("axis", "pod"),
                ratio=grad_compression.get("ratio", 0.01))
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        optimizer.update(grads, state["opt"], state["params"],
                         int(state["step"]))
        del grads
        state["step"] = state["step"] + 1
        return state, {"loss": loss, "grad_norm": gnorm.detach()}

    return train_step


def train_loop(cfg: ModelConfig, *, steps: int, batch: int, seq_len: int,
               optimizer: OptimizerDef, data_iter, seed: int = 0,
               log_every: int = 10, remat: str = "none", microbatch=None,
               callback: Optional[Callable] = None, device=None):
    """Single-host loop (examples and tests): random parameters from
    ``seed`` on ``device`` (``None``: the card), ``steps`` steps over
    ``data_iter(step)`` batches. Returns (state, losses)."""
    params = T.init_lm(cfg, seed, device=device)
    state = TrainState(params, optimizer.init(params), 0)
    step_fn = make_train_step(cfg, optimizer, remat=remat,
                              microbatch=microbatch)
    losses = []
    for s in range(steps):
        state, metrics = step_fn(state, data_iter(s))
        losses.append(float(metrics["loss"]))
        if callback is not None:
            callback(s, state, metrics)
    return state, losses
