"""Carry the reference package's LM parameters and train state into the
port.

The reference keeps its parameters as a pytree of arrays: ``embed``,
``final_norm``, optionally ``unembed``, and ``blocks``, one dict per block
kind of the super-block whose leaves carry a leading ``n_superblocks``
axis; the encoder-decoder pattern adds ``encoder`` (leaves stacked over
``n_enc_layers``), ``enc_norm`` and ``cross`` (stacked over
``n_superblocks``). Handed over as numpy arrays (``jax.tree.map(np.asarray, params)``),
they become the port's parameters with the same structure, names and
layouts (``wq`` ``[d, H, hd]``, ``wo`` ``[H, hd, d]``, ...), so both
packages compute from the same numbers. A reference ``TrainState``
(``{"params", "opt", "step"}``, with AdamW's, Adafactor's or 8-bit AdamW's
state) comes over with ``state_from_numpy``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import _device, _tree

from .config import ModelConfig


def params_from_numpy(tree, cfg: ModelConfig, *, device=None) -> dict:
    """The reference pytree (numpy leaves) -> the port's parameter dict on
    ``device`` (``None``: the card). Checks the structure and every stacked
    leaf's leading axis against ``cfg``: ``n_superblocks`` for ``blocks``
    and ``cross``, ``n_enc_layers`` for ``encoder``."""
    dev = _device.resolve(device)
    want = {"embed", "final_norm", "blocks"} | (
        set() if cfg.tie_embeddings else {"unembed"})
    stacked = {"blocks": cfg.n_superblocks}
    if cfg.layer_pattern == "encdec":
        want |= {"encoder", "enc_norm", "cross"}
        stacked.update(encoder=cfg.n_enc_layers, cross=cfg.n_superblocks)
    if set(tree) != want:
        raise ValueError(f"parameter tree has keys {sorted(tree)}, "
                         f"expected {sorted(want)}")
    if len(tree["blocks"]) != len(cfg.block_kinds()):
        raise ValueError(f"{len(tree['blocks'])} block kinds, expected "
                         f"{len(cfg.block_kinds())}")

    def conv(node, n, name):
        if isinstance(node, dict):
            return {k: conv(v, n, name) for k, v in node.items()}
        arr = np.asarray(node)
        if n is not None and arr.shape[0] != n:
            raise ValueError(f"{name} leaf of shape {arr.shape} lacks the "
                             f"leading axis of {n}")
        return torch.from_numpy(np.array(arr)).to(dev)   # a writable copy

    out = {k: conv(v, stacked.get(k), k) for k, v in tree.items()
           if k != "blocks"}
    out["blocks"] = [conv(b, cfg.n_superblocks, "blocks")
                     for b in tree["blocks"]]
    return out


_LEAF_STATES = ({"v"}, {"vr", "vc"}, {"mq", "ms", "vq", "vs"})


def state_from_numpy(tree, cfg: ModelConfig, *, device=None) -> dict:
    """A reference ``TrainState`` (numpy leaves) -> the port's
    ``train.TrainState`` on ``device`` (``None``: the card): parameters,
    the optimizer state and the step. The optimizer state is AdamW's ``{m,
    v}`` (f32 trees shaped like the parameters), or a tree shaped like the
    parameters whose leaves are Adafactor's ``{vr, vc}`` / ``{v}`` or 8-bit
    AdamW's ``{mq, ms, vq, vs}``."""
    if set(tree) != {"params", "opt", "step"}:
        raise ValueError("expected a train state {params, opt, step}, got "
                         f"keys {sorted(tree)}")
    params = params_from_numpy(tree["params"], cfg, device=device)
    opt = tree["opt"]
    if isinstance(opt, dict) and set(opt) == {"m", "v"}:
        opt = {k: params_from_numpy(opt[k], cfg, device=device)
               for k in ("m", "v")}
    else:
        nodes = _tree.leaf_nodes(tree["params"], opt)
        if any(not isinstance(n, dict) or set(n) not in _LEAF_STATES
               for n in nodes):
            raise ValueError("expected AdamW's {m, v} or a per-parameter "
                             "optimizer state with keys "
                             f"{[sorted(k) for k in _LEAF_STATES]}")
        dev = _device.resolve(device)
        opt = _tree.unflatten(tree["params"], [
            {k: torch.from_numpy(np.array(np.asarray(v))).to(dev)
             for k, v in n.items()} for n in nodes])
    return {"params": params, "opt": opt,
            "step": torch.tensor(int(np.asarray(tree["step"])),
                                 dtype=torch.int32)}
