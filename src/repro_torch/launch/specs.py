"""Cell builders: (architecture x input shape x mesh) -> the step callable,
its arguments as ``meta`` tensors, their logical specs, the arguments it
updates in place and a description of the cell. Nothing is drawn or
allocated here: every argument lives on the ``meta`` device, as the
reference builds its cells through ``jax.eval_shape``.

Mirrors the reference's ``src/repro/launch/specs.py``, including its
``REPRO_*`` experiment knobs (baselines leave them unset):

* ``REPRO_SHARDING_MODE`` (``_sharding_mode``): "auto" or "replicate";
* ``REPRO_LONG_WINDOW`` (``_long_window``): the Roaring active-set window
  of the long_500k decode cell;
* ``REPRO_PARAM_DTYPE``: the parameters' dtype;
* ``REPRO_MICROBATCH``: the training microbatch (0: none).

A spec is the reference's ``PartitionSpec`` as a tuple: one mesh dimension
name, a tuple of names or None per tensor dim (``distributed.sharding``).
A mesh is a named ``DeviceMesh`` or a ``{name: size}`` mapping; only its
sizes are read.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import torch

from repro_torch import _tree
from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed import sharding as sh
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptimizerDef, adafactor, adamw, cosine_schedule
from repro_torch.train import make_train_step

GIANT_PARAM_THRESHOLD = 50e9          # above this: adafactor (factored stats)
ENC_FRAMES = 256                      # audio stub frames (whisper)
VIS_TOKENS = 64                       # vision stub patches (qwen2-vl)
LONG_CONTEXT = 1 << 19                # decode caches this long shard on seq


def _sharding_mode(cfg: ModelConfig) -> str:
    """auto | replicate (reference ``specs.py:29``). ``REPRO_SHARDING_MODE``
    overrides; "replicate" is the pure data-parallel layout for small
    models."""
    return os.environ.get("REPRO_SHARDING_MODE") or "auto"


def _long_window() -> Optional[int]:
    """``REPRO_LONG_WINDOW=<tokens>`` (reference ``specs.py:38``): the Roaring
    sliding-window + sink active set of the long_500k decode cell (the
    serving layer's page table keeps only the window plus global-sink pages
    live), so its cache holds that many positions."""
    v = os.environ.get("REPRO_LONG_WINDOW")
    return int(v) if v else None


def pick_optimizer(cfg: ModelConfig) -> OptimizerDef:
    """The reference's choice: Adafactor above ``GIANT_PARAM_THRESHOLD``
    parameters, else AdamW, both on a cosine schedule (peak 3e-4, 2,000
    warm-up steps, 100,000 in all)."""
    lr = cosine_schedule(3e-4, warmup=2000, total=100_000)
    if cfg.param_count() > GIANT_PARAM_THRESHOLD:
        return adafactor(lr)
    return adamw(lr)


def input_specs(arch: str, shape: str) -> dict:
    """name -> (shape, torch dtype) of every model input of the cell, as
    the reference's ``input_specs``:

    train:   {tokens, mask[, extra_embeds][, memory]}
    prefill: {tokens[, extra_embeds][, memory]}
    decode:  {tokens (B, 1), pos (B,)[, memory]}  (caches built separately)
    """
    cfg = get_config(arch)
    spec = SHAPES[shape]
    B, S = spec.global_batch, spec.seq_len
    out: dict = {}
    if spec.kind == "train":
        out["tokens"] = ((B, S + 1), torch.int32)
        out["mask"] = ((B, S + 1), torch.float32)
    elif spec.kind == "prefill":
        out["tokens"] = ((B, S), torch.int32)
    else:
        out["tokens"] = ((B, 1), torch.int32)
        out["pos"] = ((B,), torch.int32)
    if cfg.frontend == "vision" and spec.kind == "train":
        out["extra_embeds"] = ((B, VIS_TOKENS, cfg.d_model), torch.bfloat16)
    if cfg.layer_pattern == "encdec":
        out["memory"] = ((B, ENC_FRAMES, cfg.d_model), torch.bfloat16)
    return out


def train_microbatch(cfg: ModelConfig, global_batch: int,
                     data_shards: int) -> Optional[int]:
    """The reference's gradient-accumulation rule for wide models: about
    two sequences per data shard per microstep (one at d_model >= 8,000),
    halved until it divides the global batch; ``None`` (no accumulation)
    below d_model 4,096."""
    if cfg.d_model < 4096:
        return None
    micro = max(data_shards * 2 // (1 if cfg.d_model < 8000 else 2),
                data_shards)
    while global_batch % micro:
        micro //= 2
    return micro


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_shardings(batch: dict, mesh, mode: str = "auto") -> dict:
    """Specs of the model inputs (reference ``specs.py:83``): dim 0 over the
    batch axes when it holds more than one row, every other dim whole."""
    bspec = sh.batch_spec(mesh, mode)
    out = {}
    for k, v in batch.items():
        dims = [None] * v.dim()
        if v.dim() and v.shape[0] > 1:
            dims[0] = bspec[0] if bspec else None
        out[k] = tuple(dims)
    return out


def cache_shardings(caches: list, mesh, long: bool = False) -> list:
    """Specs of the decode caches (reference ``specs.py:94``): batch over the
    data axes; heads (or head_dim, when the KV head count does not divide
    the model axis) over "model"; a long-context KV cache shards its
    sequence over every axis when that divides it (attention then reduces
    to a shard-local partial softmax and small all-reduces), else over the
    data axes."""
    sizes = sh.mesh_sizes(mesh)
    model_n = sizes["model"]
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    data_n = math.prod(sizes[a] for a in data_axes)
    batch_axes = data_axes if len(data_axes) > 1 else data_axes[0]

    def spec_for(key, leaf):
        shp = leaf.shape

        def div(i, n):
            return shp[i] % n == 0 and shp[i] >= n
        b = batch_axes if div(1, data_n) else None
        if key in ("k", "v"):                 # [n_sb, B, S, KVH, hd]
            if long and div(2, data_n * model_n):
                return (None, None, (*data_axes, "model"), None, None)
            heads = "model" if div(3, model_n) else None
            hd = "model" if heads is None and div(4, model_n) else None
            if long and div(2, data_n):
                return (None, None, batch_axes, heads, hd)
            return (None, b, None, heads, hd)
        if key == "conv":                      # [n_sb, B, K-1, di]
            return (None, b, None, "model" if div(3, model_n) else None)
        if key == "h":                         # [n_sb, B, di, st]
            if b is None and div(2, data_n * model_n):
                return (None, None, (*data_axes, "model"), None)
            return (None, b, "model" if div(2, model_n) else None, None)
        if key == "S":                         # [n_sb, B, H, hd, hd]
            return (None, b, "model" if div(2, model_n) else None, None,
                    None)
        if key in ("x_tm", "x_cm"):            # [n_sb, B, d]
            return (None, b, "model" if div(2, model_n) else None)
        return ()

    return [{k: spec_for(k, v) for k, v in c.items()} for c in caches]


def build_cell(arch: str, shape: str, mesh):
    """``(fn, args, specs, donate_argnums, meta)`` of one cell (reference
    ``specs.py:147``).

    ``args`` are ``meta`` tensors in the reference's tree layout: train
    ``({"params", "opt", "step"}, batch)``, prefill ``(params, batch)``,
    decode ``(params, caches, batch)``. ``specs`` mirrors ``args`` with a
    logical spec per leaf (read them in ``args``' order with
    ``_tree.leaf_nodes``). ``donate_argnums`` is the reference's; here it
    names the arguments ``fn`` updates in place (the train state, the
    decode caches). ``meta`` has the reference's keys. ``fn`` runs on real
    tensors on any device; realizing ``args`` there (allocate, then fill
    from a seed) is the caller's step.
    """
    cfg = get_config(arch)
    if os.environ.get("REPRO_PARAM_DTYPE"):
        cfg = dataclasses.replace(cfg,
                                  param_dtype=os.environ["REPRO_PARAM_DTYPE"])
    spec = SHAPES[shape]
    B, S = spec.global_batch, spec.seq_len
    mode = _sharding_mode(cfg)
    batch = {k: _meta(shp, dt)
             for k, (shp, dt) in input_specs(arch, shape).items()}
    batch_sh = _batch_shardings(batch, mesh, mode)
    params = T.init_lm(cfg, device="meta")
    params_sh = sh.params_specs(params, mesh, mode)
    meta = {"arch": arch, "shape": shape, "kind": spec.kind,
            "seq_len": S, "global_batch": B,
            "n_superblocks": cfg.n_superblocks,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count()}

    if spec.kind == "train":
        opt = pick_optimizer(cfg)
        opt_state = opt.init(params)
        state = {"params": params, "opt": opt_state,
                 "step": _meta((), torch.int32)}
        state_sh = {"params": params_sh,
                    "opt": sh.params_specs(opt_state, mesh, mode),
                    "step": ()}
        sizes = sh.mesh_sizes(mesh)
        dcount = math.prod(sizes[a] for a in ("pod", "data") if a in sizes)
        micro = train_microbatch(cfg, B, dcount)
        if os.environ.get("REPRO_MICROBATCH"):
            micro = int(os.environ["REPRO_MICROBATCH"]) or None
        step = make_train_step(cfg, opt, remat="full", microbatch=micro)
        meta["optimizer"] = opt.name
        meta["microbatch"] = micro
        return step, (state, batch), (state_sh, batch_sh), (0,), meta

    if spec.kind == "prefill":
        def prefill(params, batch):
            logits, _ = T.forward(params, batch["tokens"], cfg,
                                  extra_embeds=batch.get("extra_embeds"),
                                  memory=batch.get("memory"))
            return logits
        return prefill, (params, batch), (params_sh, batch_sh), (), meta

    # decode: serve_step over a dense KV / state cache of seq_len positions
    long = S >= LONG_CONTEXT
    S_cache = S
    if long and _long_window() and all(
            k.startswith("attn") for k in cfg.block_kinds()):
        # Roaring active-set decode: window + global-sink pages only (the
        # page table evicts the rest by ANDNOT); the cache shrinks to match
        S_cache = min(S, _long_window())
        meta["long_window"] = S_cache
    caches = T.init_decode_caches(cfg, B, s_max=S_cache, device="meta")
    caches_sh = cache_shardings(caches, mesh, long=long)

    def serve_step(params, caches, batch):
        return T.decode_step(params, caches, batch["tokens"], batch["pos"],
                             cfg, memory=batch.get("memory"))

    return (serve_step, (params, caches, batch),
            (params_sh, caches_sh, batch_sh), (1,), meta)


def shard_shape(shape, spec: tuple, mesh) -> tuple:
    """The per-rank shape of a tensor of ``shape`` placed by ``spec``: each
    dim divided by the product of the mesh dimensions it names (rounded up,
    as an uneven shard's largest piece)."""
    sizes = sh.mesh_sizes(mesh)
    out = list(shape)
    for i, ax in enumerate(spec):
        if ax is not None:
            n = math.prod(sizes[a] for a in (ax if isinstance(ax, tuple)
                                             else (ax,)))
            out[i] = -(-out[i] // n)
    return tuple(out)


def rank_bytes(args, specs, mesh) -> int:
    """Bytes of ``args`` that one rank holds under ``specs``: the sum over
    leaves of the shard's elements times the element size."""
    return sum(math.prod(shard_shape(t.shape, s, mesh)) * t.element_size()
               for t, s in zip(_tree.leaves(args),
                               _tree.leaf_nodes(args, specs)))
