"""RWKV-6 "Finch" block: time-mix with data-dependent decay + channel-mix.

Attention-free: per-head state S in R^{hd x hd} evolves as
    S_t = diag(w_t) S_{t-1} + k_t^T v_t,     y_t = r_t (S_{t-1} + u k_t^T v_t)
with w_t a *data-dependent* decay and a bonus term u for the current token.
The sequence path scans over time (``scan_utils.chunked_scan``); decode is
a single-step recurrence, O(1) per token.

As in the reference: token-shift is a plain previous-token mix (no LoRA on
the mix coefficients) and the decay LoRA is a single dense layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import common
from .config import ModelConfig
from .scan_utils import chunked_scan

HEAD_DIM = 64


def rwkv_init(cfg: ModelConfig, dtype, *, generator, stack=None) -> dict:
    d = cfg.d_model
    H = d // HEAD_DIM
    f = cfg.d_ff
    dev = generator.device
    lead = () if stack is None else (stack,)

    def w(shape, scale=1.0):
        return common.dense_init(shape, dtype, generator=generator,
                                 stack=stack, scale=scale)

    def full(shape, v):
        return torch.full((*lead, *shape), v, dtype=torch.float32,
                          device=dev)
    return {
        "wr": w((d, d)), "wk": w((d, d)), "wv": w((d, d)), "wg": w((d, d)),
        "wo": w((d, d)), "w_decay": w((d, d), 0.1),
        "decay_bias": full((d,), -6.0),
        "bonus_u": full((H, HEAD_DIM), 0.0),
        "mix": full((5, d), 0.5),                  # r, k, v, g, w token-shift
        "ln_x": common.layer_norm_init(d, torch.float32, device=dev,
                                       stack=stack),
        "cwi": w((d, f)), "cwo": w((f, d)),
        "cmix": full((1, d), 0.5),
    }


def _time_shift(x):
    return F.pad(x, (0, 0, 1, 0))[:, :-1, :]


def _mix(x, xprev, coeff):
    return x * coeff + xprev * (1.0 - coeff)


def _rkvgw(params, x, xp):
    """The five token-shift-mixed projections: r, k, v, g in x's dtype and
    the decay w = exp(-exp(bias + lora)) in float32."""
    mix = [params["mix"][i].to(x.dtype) for i in range(5)]
    r, k, v, g, wdec = (torch.matmul(_mix(x, xp, m), params[n].to(x.dtype))
                        for m, n in zip(mix, ("wr", "wk", "wv", "wg",
                                              "w_decay")))
    w = torch.exp(-torch.exp(params["decay_bias"] + wdec.float()))
    return r, k, v, g, w


def _out(params, y, g, x):
    """Group-norm-free output: layer norm of y, SiLU gate, out-projection."""
    y = common.layer_norm(params["ln_x"], y)
    y = y * F.silu(g.float())
    return torch.matmul(y.to(x.dtype), params["wo"].to(x.dtype))


def rwkv_time_mix(params, x, cfg: ModelConfig):
    B, L, d = x.shape
    H = d // HEAD_DIM
    r, k, v, g, w = _rkvgw(params, x, _time_shift(x))
    r, k, v, w = (t.reshape(B, L, H, HEAD_DIM).float() for t in (r, k, v, w))
    u = params["bonus_u"]

    def step(S, xs):
        r_t, k_t, v_t, w_t = xs                          # [B, H, hd]
        kv = k_t[..., :, None] * v_t[..., None, :]       # [B, H, hd, hd]
        y = torch.einsum("bhk,bhkv->bhv", r_t, S + u[None, :, :, None] * kv)
        return w_t[..., :, None] * S + kv, y

    S0 = torch.zeros((B, H, HEAD_DIM, HEAD_DIM), dtype=torch.float32,
                     device=x.device)
    _, ys = chunked_scan(step, S0, tuple(t.transpose(0, 1)
                                         for t in (r, k, v, w)))
    return _out(params, ys.transpose(0, 1).reshape(B, L, d), g, x)


def rwkv_channel_mix(params, x, cfg: ModelConfig):
    xm = _mix(x, _time_shift(x), params["cmix"][0].to(x.dtype))
    h = torch.matmul(xm, params["cwi"].to(x.dtype))
    h = torch.square(F.relu(h.float())).to(x.dtype)
    return torch.matmul(h, params["cwo"].to(x.dtype))


def rwkv_decode_step(params, x, state, cfg: ModelConfig):
    """x: [B, 1, d]; state: (x_prev_tm [B, d], S [B, H, hd, hd], x_prev_cm
    [B, d]). Returns ``(out [B, 1, d], (x_prev_tm, S, x_prev_cm))``."""
    B, _, d = x.shape
    H = d // HEAD_DIM
    x_tm, S, x_cm = state
    r, k, v, g, w = _rkvgw(params, x, x_tm[:, None, :].to(x.dtype))
    r, k, v, w = (t.reshape(B, H, HEAD_DIM).float() for t in (r, k, v, w))
    u = params["bonus_u"]
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", r, S + u[None, :, :, None] * kv)
    S = w[..., :, None] * S + kv
    return _out(params, y.reshape(B, 1, d), g, x), (x[:, 0, :], S, x_cm)


def rwkv_channel_mix_step(params, x, x_prev, cfg: ModelConfig):
    xm = _mix(x, x_prev[:, None, :].to(x.dtype),
              params["cmix"][0].to(x.dtype))
    h = torch.matmul(xm, params["cwi"].to(x.dtype))
    h = torch.square(F.relu(h.float())).to(x.dtype)
    return torch.matmul(h, params["cwo"].to(x.dtype)), x[:, 0, :]
