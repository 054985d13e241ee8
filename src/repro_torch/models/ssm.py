"""Mamba-style selective SSM block (for the jamba hybrid).

Mamba-1 shapes: in-projection to 2 * d_inner (x, gate z), a short causal
depthwise conv, a data-dependent (dt, B, C) selective scan over a
d_state-wide latent, out-projection. ``A`` and ``dt`` are float32; the scan
runs over time through ``scan_utils.chunked_scan`` and has a single-step
form for decode.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import common
from .config import ModelConfig
from .scan_utils import chunked_scan


def mamba_init(cfg: ModelConfig, dtype, *, generator, stack=None) -> dict:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    st = cfg.ssm_state
    dev = generator.device
    lead = () if stack is None else (stack,)

    def w(shape, scale=1.0):
        return common.dense_init(shape, dtype, generator=generator,
                                 stack=stack, scale=scale)
    # S4-style A initialization: -[1..st] per channel, stored as log(-A)
    a = torch.arange(1, st + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": w((d, 2 * di)),
        "conv_w": w((cfg.ssm_conv, di), 0.5),
        "x_proj": w((di, 2 * st + 1)),
        "dt_bias": torch.full((*lead, di), float(np.log(np.expm1(0.01))),
                              dtype=torch.float32, device=dev),
        "log_neg_a": torch.log(a).expand(*lead, di, st).clone(),
        "d_skip": torch.ones((*lead, di), dtype=torch.float32, device=dev),
        "out_proj": w((di, d)),
    }


def _ssm_scan(u, dt, B, Cm, A):
    """u, dt: [Bt, L, di]; B, Cm: [Bt, L, st]; A: [di, st] -> [Bt, L, di]."""
    dA = torch.exp(dt[..., None] * A)                         # [Bt,L,di,st]
    dBu = dt[..., None] * B[:, :, None, :] * u[..., None]     # [Bt,L,di,st]

    def step(h, xs):
        dA_t, dBu_t, C_t = xs
        h = h * dA_t + dBu_t                                  # [Bt,di,st]
        return h, torch.sum(h * C_t[:, None, :], dim=-1)      # [Bt,di]

    Bt, L, di, st = dA.shape
    h0 = torch.zeros((Bt, di, st), dtype=torch.float32, device=u.device)
    xs = (dA.transpose(0, 1), dBu.transpose(0, 1), Cm.transpose(0, 1))
    _, ys = chunked_scan(step, h0, xs)
    return ys.transpose(0, 1)


def _proj(params, u, x, cfg: ModelConfig):
    """(dt [.., di], B [.., st], C [.., st]) in float32 from the conv
    output ``u`` (float32)."""
    st = cfg.ssm_state
    proj = torch.matmul(u.to(x.dtype), params["x_proj"].to(x.dtype)).float()
    dt = F.softplus(proj[..., 0:1] + params["dt_bias"])
    return dt, proj[..., 1:1 + st], proj[..., 1 + st:]


def mamba(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: [B, L, d] -> [B, L, d]."""
    Bt, L, d = x.shape
    di = cfg.ssm_expand * d
    xz = torch.matmul(x, params["in_proj"].to(x.dtype))
    u, z = xz[..., :di], xz[..., di:]
    # causal depthwise conv (width ssm_conv) as the reference's sum of
    # shifted products
    w = params["conv_w"].to(x.dtype)                          # [K, di]
    upad = F.pad(u, (0, 0, cfg.ssm_conv - 1, 0))
    conv = upad[:, 0:L, :] * w[0]
    for i in range(1, cfg.ssm_conv):
        conv = conv + upad[:, i:i + L, :] * w[i]
    u = F.silu(conv.float())
    dt, Bm, Cm = _proj(params, u, x, cfg)
    A = -torch.exp(params["log_neg_a"])                       # [di, st]
    y = _ssm_scan(u, dt, Bm, Cm, A)
    y = y + u * params["d_skip"]
    y = y * F.silu(z.float())
    return torch.matmul(y.to(x.dtype), params["out_proj"].to(x.dtype))


def mamba_decode_step(params: dict, x: torch.Tensor, state,
                      cfg: ModelConfig):
    """Single-token step. x: [B, 1, d]; state: (conv_buf [B, K-1, di], h
    [B, di, st]). Returns ``(out [B, 1, d], (conv_buf, h))``, new tensors."""
    conv_buf, h = state
    di = cfg.ssm_expand * x.shape[-1]
    xz = torch.matmul(x, params["in_proj"].to(x.dtype))
    u, z = xz[..., :di], xz[..., di:]
    w = params["conv_w"].to(x.dtype)
    hist = torch.cat([conv_buf.to(u.dtype), u], dim=1)        # [B, K, di]
    u1 = torch.einsum("bke,ke->be", hist, w)[:, None, :]
    u1 = F.silu(u1.float())
    dt, Bm, Cm = _proj(params, u1, x, cfg)
    A = -torch.exp(params["log_neg_a"])
    dA = torch.exp(dt[:, 0, :, None] * A)
    dBu = dt[:, 0, :, None] * Bm[:, 0, None, :] * u1[:, 0, :, None]
    h = h * dA + dBu
    y = torch.sum(h * Cm[:, 0, None, :], dim=-1)[:, None, :]
    y = y + u1 * params["d_skip"]
    y = y * F.silu(z.float())
    out = torch.matmul(y.to(x.dtype), params["out_proj"].to(x.dtype))
    return out, (hist[:, 1:, :], h)
