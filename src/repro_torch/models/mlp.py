"""The dense MLP (gated SwiGLU, or GPT-style two-matrix with GELU) and the
reference's capacity-based MoE.

The MoE routes each token to its top-k experts, gives every (expert,
capacity slot) pair at most one token, runs the expert FFNs as one batched
product over the expert dimension, and combines the results with the
routing weights; pairs past an expert's capacity are dropped (the token
keeps only its residual stream there). Capacity is per group of tokens, so
a token's output depends on the batch it is routed with.

``REPRO_MOE_GATHER`` (the reference's experiment knob, unset in baselines)
pins the expert weights to ``("model", None, None)`` before the expert
products, so a sharded launcher gathers each layer's weights once and the
products run shard-local. It is kept for parity with the reference: it can
act only on DTensor weights under ``data_axes``, and no path of the port
places a model's weights so, so it is read only there.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from repro_torch.distributed import context as dctx

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


def moe_init(cfg: ModelConfig, dtype, *, generator, stack=None) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def w(shape, dt=dtype):
        return common.dense_init(shape, dt, generator=generator, stack=stack)
    return {"router": w((d, e), torch.float32), "wi": w((e, d, f)),
            "wg": w((e, d, f)), "wo": w((e, f, d))}


def route(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig,
          G: int = 1):
    """The reference's routing of ``x`` ([N, d], N a multiple of ``G``)
    over ``G`` groups of consecutive tokens:
    ``(probs [N, E], gate_vals [N, K], gate_idx [N, K], slot [G, NG * K],
    keep [G, NG * K], C)``. Top-k ties go to the lower expert index, as
    ``jax.lax.top_k`` breaks them (a stable descending sort; ``torch.topk``
    orders no ties); capacity slots are an exclusive cumsum per group in
    pair order (token-major, k-minor)."""
    N = x.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    NG = N // G
    C = max(1, int(math.ceil(cfg.capacity_factor * NG * K / E)))
    logits = torch.matmul(x.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :K], idx[:, :K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    onehot = F.one_hot(gate_idx.reshape(G, NG * K), E)       # [G, NG*K, E]
    slot = ((torch.cumsum(onehot, dim=1) - onehot) * onehot).sum(-1)
    return probs, gate_vals, gate_idx, slot, slot < C, C


def moe(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """Returns ``(output [B, S, d], aux_loss)``. x: [B, S, d].

    The reference's per-data-shard grouping: ``dctx.data_shard_count()``
    groups of batch-major tokens (1 outside a launcher's mesh), each with
    its own capacity ``C = ceil(capacity_factor * NG * K / E)``. Expert
    products in ``x``'s dtype; the combine sums each token's k pairs in
    pair order in that dtype, as the reference's scatter-add does.
    """
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = B * S
    G = dctx.data_shard_count()
    if B % G:                   # groups must align with the batch shards
        G = 1
    NG = N // G
    xf = x.reshape(N, d)
    probs, gate_vals, gate_idx, slot, keep, C = route(params["router"], xf,
                                                      cfg, G)
    # Switch-style load-balancing loss
    me = probs.mean(0)
    ce = F.one_hot(gate_idx[:, 0], E).float().mean(0)
    aux = E * torch.sum(me * ce)

    eg = gate_idx.reshape(G, NG * K)
    gates = gate_vals.reshape(G, NG * K) * keep.to(gate_vals.dtype)
    g_of = torch.arange(G, device=x.device)[:, None].expand(G, NG * K)
    tok = torch.arange(NG, device=x.device).repeat_interleave(K)
    # each kept pair owns one (group, expert, slot) row of the buffers
    cell = (g_of * E + eg) * C + torch.clamp(slot, max=C - 1)
    expert_in = torch.zeros((G * E * C, d), dtype=x.dtype, device=x.device)
    src = xf.reshape(G, NG, d)[g_of, tok[None].expand(G, -1)]
    expert_in[cell[keep]] = src[keep]
    expert_in = dctx.constrain(expert_in.reshape(G, E, C, d),
                               ("data", "model", None, None))

    wi, wg, wo = (params[k].to(x.dtype) for k in ("wi", "wg", "wo"))
    if dctx.placed(wi) and os.environ.get("REPRO_MOE_GATHER"):
        wi, wg, wo = (dctx.constrain(w, ("model", None, None))
                      for w in (wi, wg, wo))
    h = torch.einsum("gecd,edf->gecf", expert_in, wi)
    g = torch.einsum("gecd,edf->gecf", expert_in, wg)
    h = F.silu(g.float()).to(x.dtype) * h
    expert_out = torch.einsum("gecf,efd->gecd", h, wo)
    expert_out = dctx.constrain(expert_out, ("data", "model", None, None))

    per_pair = expert_out.reshape(G * E * C, d)[cell]         # [G, NG*K, d]
    per_pair = (per_pair * gates[..., None].to(x.dtype)).reshape(G, NG, K, d)
    out = per_pair[:, :, 0]
    for k in range(1, K):
        out = out + per_pair[:, :, k]
    return out.reshape(B, S, d), aux
