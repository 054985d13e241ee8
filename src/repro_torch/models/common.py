"""Shared model components: norms, embeddings, RoPE, initializers.

Parameters are plain dicts of tensors; every component is an ``init`` that
takes an explicit ``torch.Generator`` plus a pure ``apply(params, x) -> y``.
The dtype rules follow the reference package: statistics and rotations in
float32, weights cast to the activation dtype at each use, and the
unembedding in the wider of the activation and table dtypes.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

NEG_INF = -1e30


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def dense_init(shape: Sequence[int], dtype, *, generator: torch.Generator,
               stack: Optional[int] = None) -> torch.Tensor:
    """A normal cut at +-2 standard deviations, scaled by ``1 /
    sqrt(shape[0])`` as the reference does. ``stack`` prepends a leading
    axis of that many independent draws (one per super-block), and the
    scale still follows the per-layer ``shape``."""
    stddev = 1.0 / max(1.0, math.sqrt(shape[0] if len(shape) > 1 else 1.0))
    full = tuple(shape) if stack is None else (stack, *shape)
    t = torch.empty(full, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(stddev).to(dtype)


def rms_norm_init(d: int, dtype, *, device, stack=None) -> dict:
    shape = (d,) if stack is None else (stack, d)
    return {"scale": torch.ones(shape, dtype=dtype, device=device)}


def rms_norm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * params["scale"].float()
    return out.to(dt)


# ---------------------------------------------------------------- rotary embeddings

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, n_heads, head_dim]; positions: broadcastable to [..., S]."""
    hd = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(hd, theta), dtype=torch.float32,
                            device=x.device)                       # [hd/2]
    ang = positions[..., :, None].float() * freqs                  # [..., S, hd/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- embeddings

def embedding_init(vocab: int, d: int, dtype, *, generator,
                   vocab_padded: Optional[int] = None) -> dict:
    vp = vocab_padded or vocab
    return {"table": dense_init((vp, d), dtype, generator=generator)}


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens.long()]


def unembed(params: dict, x: torch.Tensor, softcap: Optional[float] = None,
            vocab: Optional[int] = None) -> torch.Tensor:
    table = params["table"]
    dt = torch.promote_types(x.dtype, table.dtype)
    logits = torch.matmul(x.to(dt), table.to(dt).T)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    vp = table.shape[0]
    if vocab is not None and vocab < vp:
        # padded vocab slots never win the softmax
        pad = torch.arange(vp, device=logits.device) >= vocab
        logits = logits.masked_fill(pad, NEG_INF)
    return logits
