"""The dense MLP: gated (SwiGLU) or GPT-style two-matrix with GELU.

The capacity-based MoE of the reference waits for a later slice (ROADMAP
queue 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import common
from .config import ModelConfig


def mlp_init(cfg: ModelConfig, dtype, *, generator, stack=None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    p = {"wi": common.dense_init((d, f), dtype, generator=generator,
                                 stack=stack)}
    if cfg.gated_mlp:
        p["wg"] = common.dense_init((d, f), dtype, generator=generator,
                                    stack=stack)
    p["wo"] = common.dense_init((f, d), dtype, generator=generator,
                                stack=stack)
    return p


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.matmul(x, params["wi"].to(x.dtype))
    if "wg" in params:
        g = torch.matmul(x, params["wg"].to(x.dtype))
        h = F.silu(g.float()).to(x.dtype) * h
    else:
        # jax.nn.gelu defaults to the tanh approximation; torch's to the
        # exact form
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return torch.matmul(h, params["wo"].to(x.dtype))
