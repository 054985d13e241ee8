"""Shared model components: norms, embeddings, RoPE / M-RoPE, initializers.

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


# the most float32 elements a draw holds at once before it is cast to a
# narrower parameter dtype (1 GiB)
_DRAW_ELEMS = 1 << 28


def dense_init(shape: Sequence[int], dtype, *, generator: torch.Generator,
               stack: Optional[int] = None,
               scale: float = 1.0) -> torch.Tensor:
    """A normal cut at +-2 standard deviations, scaled by ``scale /
    sqrt(shape[0])`` as the reference does. ``stack`` prepends a leading
    axis of that many independent draws (one per super-block), and the
    scale still follows the per-layer ``shape``.

    A float32 leaf is drawn whole. A narrower one is drawn in float32
    slices of at most ``_DRAW_ELEMS`` elements along its flattened leading
    axes, each cast into the result as it is drawn, so no float32 copy of a
    whole stacked leaf exists (dbrx-132b's stacked expert matrices would
    need 34 GB).

    On the ``meta`` device (``generator`` is then ``seeded_generator``'s
    stand-in) the leaf has its shape and dtype and nothing is drawn."""
    stddev = scale / max(1.0, math.sqrt(shape[0] if len(shape) > 1
                                        else 1.0))
    full = tuple(shape) if stack is None else (stack, *shape)
    dev = generator.device
    if dev.type == "meta":
        return torch.empty(full, dtype=dtype, device=dev)
    if dtype == torch.float32:
        t = torch.empty(full, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return t.mul_(stddev)
    out = torch.empty(full, dtype=dtype, device=dev)
    rows = out.view(-1, full[-1])
    step = max(1, _DRAW_ELEMS // full[-1])
    for r0 in range(0, rows.shape[0], step):
        t = torch.empty((min(step, rows.shape[0] - r0), full[-1]),
                        dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        rows[r0:r0 + t.shape[0]] = t.mul_(stddev)
    return out


class _ShapeOnly:
    """Stands in for a ``torch.Generator`` on the ``meta`` device, which has
    none: the initializers read its ``device`` and draw nothing."""
    device = torch.device("meta")


def seeded_generator(seed: int, device: torch.device):
    """A ``torch.Generator`` on ``device`` seeded with ``seed``; on ``meta``,
    the stand-in that makes the initializers build shapes only."""
    if device.type == "meta":
        return _ShapeOnly()
    return torch.Generator(device=device).manual_seed(seed)


def rms_norm_init(d: int, dtype, *, device, stack=None) -> dict:
    shape = (d,) if stack is None else (stack, d)
    return {"scale": torch.ones(shape, dtype=dtype, device=device)}


def rms_norm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * params["scale"].float()
    return out.to(dt)


def layer_norm_init(d: int, dtype, *, device, stack=None) -> dict:
    shape = (d,) if stack is None else (stack, d)
    return {"scale": torch.ones(shape, dtype=dtype, device=device),
            "bias": torch.zeros(shape, dtype=dtype, device=device)}


def layer_norm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    out = ((x - mu) * torch.rsqrt(var + eps) * params["scale"].float()
           + params["bias"].float())
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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Sequence[int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the head_dim/2 frequency slots are split
    into (t, h, w) sections, each rotated by its own position stream.

    x: [..., S, H, hd]; positions: [..., S, 3] (text-only inputs pass the
    same value in all three streams, which is 1-D RoPE exactly)."""
    hd = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(hd, theta), dtype=torch.float32,
                            device=x.device)                       # [hd/2]
    sec = np.asarray(sections)
    assert sec.sum() == hd // 2, (sections, hd)
    stream_id = torch.as_tensor(np.repeat(np.arange(3), sec),
                                device=x.device)                   # [hd/2]
    pos = positions.float().index_select(-1, stream_id)            # [..., S, hd/2]
    ang = pos * freqs
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
