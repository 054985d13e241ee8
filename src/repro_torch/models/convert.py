"""Carry the reference package's LM parameters and train state into the
port.

The reference keeps its parameters as a pytree of arrays: ``embed``,
``final_norm``, optionally ``unembed``, and ``blocks``, one dict per block
kind of the super-block whose leaves carry a leading ``n_superblocks``
axis. Handed over as numpy arrays (``jax.tree.map(np.asarray, params)``),
they become the port's parameters with the same structure, names and
layouts (``wq`` ``[d, H, hd]``, ``wo`` ``[H, hd, d]``, ...), so both
packages compute from the same numbers. A reference ``TrainState``
(``{"params", "opt": {"m", "v"}, "step"}``, AdamW's moments shaped like
the parameters) comes over with ``state_from_numpy``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import _device

from .config import ModelConfig
from .transformer import check_supported


def params_from_numpy(tree, cfg: ModelConfig, *, device=None) -> dict:
    """The reference pytree (numpy leaves) -> the port's parameter dict on
    ``device`` (``None``: the card). Checks the structure and every block
    leaf's leading super-block axis against ``cfg``."""
    check_supported(cfg)
    dev = _device.resolve(device)
    want = {"embed", "final_norm", "blocks"} | (
        set() if cfg.tie_embeddings else {"unembed"})
    if set(tree) != want:
        raise ValueError(f"parameter tree has keys {sorted(tree)}, "
                         f"expected {sorted(want)}")
    if len(tree["blocks"]) != len(cfg.block_kinds()):
        raise ValueError(f"{len(tree['blocks'])} block kinds, expected "
                         f"{len(cfg.block_kinds())}")

    def conv(node, stacked):
        if isinstance(node, dict):
            return {k: conv(v, stacked) for k, v in node.items()}
        arr = np.asarray(node)
        if stacked and arr.shape[0] != cfg.n_superblocks:
            raise ValueError(f"block leaf of shape {arr.shape} lacks the "
                             f"{cfg.n_superblocks} super-blocks")
        return torch.from_numpy(np.array(arr)).to(dev)   # a writable copy

    out = {k: conv(v, False) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [conv(b, True) for b in tree["blocks"]]
    return out


def state_from_numpy(tree, cfg: ModelConfig, *, device=None) -> dict:
    """A reference AdamW ``TrainState`` (numpy leaves) -> the port's
    ``train.TrainState`` on ``device`` (``None``: the card): parameters,
    moments ``m`` / ``v`` (f32, shaped like the parameters) and the step."""
    if set(tree) != {"params", "opt", "step"} or set(tree["opt"]) != {"m",
                                                                      "v"}:
        raise ValueError("expected an AdamW train state {params, opt: {m, "
                         f"v}}, step}}, got keys {sorted(tree)}")
    return {"params": params_from_numpy(tree["params"], cfg, device=device),
            "opt": {k: params_from_numpy(tree["opt"][k], cfg, device=device)
                    for k in ("m", "v")},
            "step": torch.tensor(int(np.asarray(tree["step"])),
                                 dtype=torch.int32)}
