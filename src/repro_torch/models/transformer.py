"""Unified LM: every architecture of the registry is a layer pattern over
sub-blocks.

Layers are stacked per *super-block* as in the reference: ``params
["blocks"]`` holds one dict per block kind of the super-block, each leaf
with a leading ``n_superblocks`` axis, and a Python loop over super-blocks
takes the place of the reference's ``lax.scan``; ``remat="full"``
checkpoints each super-block, as the reference checkpoints its scan body,
and ``remat="dots"`` checkpoints it keeping the outputs of its matrix
products (the reference's ``checkpoint_dots`` policy).

Supports dense GQA decoders, gemma2's local / global alternation with
softcaps, MoE (uniform or alternating), jamba's 7:1 Mamba / attention
hybrid with MoE, RWKV6, whisper's encoder-decoder (audio frontend stub) and
qwen2-vl (vision stub, M-RoPE). Decode runs one token against per-layer
caches (``init_decode_caches`` / ``decode_step``: KV, conv / SSM state,
RWKV state) for every pattern, and against the Roaring-paged KV pools
(``init_paged_caches`` / ``decode_step_paged``) for attention-only
patterns.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch import _device
from repro_torch.distributed import context as dctx

from . import attention as attn_mod
from . import common, mlp as mlp_mod, rwkv as rwkv_mod, ssm as ssm_mod
from .config import ModelConfig


def _layer(tree, i: int):
    """The ``i``-th super-block's view of a stacked parameter or pool tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """Token embeddings in the compute dtype, with gemma's sqrt(d) scale
    (rounded to the compute dtype) where ``logit_softcap`` is set."""
    x = common.embed(params["embed"], tokens).to(
        common.dtype_of(cfg.compute_dtype))
    if cfg.logit_softcap is not None:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _logits(params: dict, x: torch.Tensor, cfg: ModelConfig):
    x = common.rms_norm(params["final_norm"], x)
    table = params["unembed"] if not cfg.tie_embeddings else params["embed"]
    return common.unembed(table, x, softcap=cfg.logit_softcap,
                          vocab=cfg.vocab)


# =============================================================================
# init
# =============================================================================

def _sublayer_init(kind: str, cfg: ModelConfig, dtype, gen, n: int) -> dict:
    d, dev = cfg.d_model, gen.device

    def norm():
        return common.rms_norm_init(d, torch.float32, device=dev, stack=n)
    if kind == "rwkv":
        return {"ln1": norm(), "ln2": norm(),
                "tm": rwkv_mod.rwkv_init(cfg, dtype, generator=gen,
                                         stack=n)}
    p = {"ln1": norm(), "ln2": norm()}
    if kind.startswith("attn"):
        p["attn"] = attn_mod.attn_init(cfg, dtype, generator=gen, stack=n)
    elif kind.startswith("mamba"):
        p["mamba"] = ssm_mod.mamba_init(cfg, dtype, generator=gen, stack=n)
    if kind.endswith("_moe"):
        p["moe"] = mlp_mod.moe_init(cfg, dtype, generator=gen, stack=n)
    else:
        p["mlp"] = mlp_mod.mlp_init(cfg, dtype, generator=gen, stack=n)
    return p


def init_lm(cfg: ModelConfig, seed: int = 0, *, device=None) -> dict:
    """Random parameters from one explicit ``torch.Generator`` seeded with
    ``seed``, drawn on ``device`` (``None``: the card). Truncated normals
    with the reference's scales; the numbers differ from the reference's
    ``jax.random`` draws (tests carry the reference's parameters over with
    ``models.convert`` instead). The encoder-decoder pattern adds
    ``encoder`` (``n_enc_layers`` stacked attention + MLP blocks),
    ``enc_norm`` and ``cross`` (one cross-attention per super-block).

    On ``device="meta"`` every leaf has its shape and dtype and nothing is
    drawn or allocated: the port's ``jax.eval_shape(lambda: init_lm(rng,
    cfg))``, for ``launch.specs.build_cell``."""
    dev = _device.resolve(device)
    gen = common.seeded_generator(seed, dev)
    dtype = common.dtype_of(cfg.param_dtype)
    n_sb = cfg.n_superblocks
    d = cfg.d_model
    params: dict[str, Any] = {
        "embed": common.embedding_init(cfg.vocab, d, dtype, generator=gen,
                                       vocab_padded=cfg.vocab_padded),
        "final_norm": common.rms_norm_init(d, torch.float32, device=dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = {"table": common.dense_init(
            (cfg.vocab_padded, d), dtype, generator=gen)}
    params["blocks"] = [_sublayer_init(kind, cfg, dtype, gen, n_sb)
                        for kind in cfg.block_kinds()]
    if cfg.layer_pattern == "encdec":
        params["encoder"] = _sublayer_init("attn_mlp", cfg, dtype, gen,
                                           cfg.n_enc_layers)
        params["enc_norm"] = common.rms_norm_init(d, torch.float32,
                                                  device=dev)
        params["cross"] = {
            "ln": common.rms_norm_init(d, torch.float32, device=dev,
                                       stack=n_sb),
            "xattn": attn_mod.attn_init(cfg, dtype, generator=gen,
                                        stack=n_sb)}
    return params


# =============================================================================
# forward (training, teacher-forced, prefill)
# =============================================================================

def _apply_sublayer(p, x, kind, cfg: ModelConfig, positions, block_lists):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = common.rms_norm(p["ln1"], x)
    if kind == "rwkv":
        x = x + rwkv_mod.rwkv_time_mix(p["tm"], h, cfg)
        h2 = common.rms_norm(p["ln2"], x)
        return x + rwkv_mod.rwkv_channel_mix(p["tm"], h2, cfg), aux
    if kind.startswith("attn"):
        x = x + attn_mod.attention(p["attn"], h, cfg, positions=positions,
                                   layer_kind=kind, block_lists=block_lists)
    elif kind.startswith("mamba"):
        x = x + ssm_mod.mamba(p["mamba"], h, cfg)
    h2 = common.rms_norm(p["ln2"], x)
    if kind.endswith("_moe"):
        out, aux = mlp_mod.moe(p["moe"], h2, cfg)
        return x + out, aux
    return x + mlp_mod.mlp(p["mlp"], h2), aux


def _superblock(params: dict, x: torch.Tensor, i: int, cfg: ModelConfig,
                positions, block_lists, memory):
    """One super-block: its sub-layers, then (encoder-decoder, with a
    memory) its cross-attention. Returns (x, the sub-layers' aux sum)."""
    x = dctx.constrain_batch(x)                 # anchor batch sharding
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j, kind in enumerate(cfg.block_kinds()):
        x, a = _apply_sublayer(_layer(params["blocks"][j], i), x, kind, cfg,
                               positions, block_lists)
        aux = aux + a
    if cfg.layer_pattern == "encdec" and memory is not None:
        cp = _layer(params["cross"], i)
        h = common.rms_norm(cp["ln"], x)
        x = x + attn_mod.cross_attention(cp["xattn"], h, memory, cfg)
    return dctx.constrain_batch(x), aux


# the matrix products whose outputs remat="dots" keeps: what matmul, einsum
# and the projections lower to
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default,
                      torch.ops.aten.baddbmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_dots_context = functools.partial(create_selective_checkpoint_contexts,
                                  _dots_policy)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            block_lists=None, extra_embeds: Optional[torch.Tensor] = None,
            memory: Optional[torch.Tensor] = None, remat: str = "none"):
    """tokens: int[B, S] -> (logits [B, S, V], aux_loss).

    ``extra_embeds``: precomputed modality embeddings ([B, S_m, d]; the
    vision / audio stubs) prepended to the token stream; their logits are
    sliced off. ``memory``: the encoder output for the encoder-decoder
    pattern. ``block_lists``: optional (kv_idx, counts) tensors on the
    tokens' device for the Roaring block-sparse path of global layers
    (``cfg.attn_impl == "sparse"``). ``aux_loss``: the MoE layers' summed
    load-balancing loss (0 without MoE). ``remat``: "none", "full" (each
    super-block is recomputed in the backward, so only super-block inputs
    are kept) or "dots" (the same, but the outputs of the super-block's
    matrix products are kept and not recomputed). Under both, a kernel
    launched through ``ctypes`` (the block-sparse attention forward) runs
    again in the recompute: the policy sees only torch's own operators.
    """
    if remat not in ("none", "full", "dots"):
        raise ValueError("remat must be 'none', 'full' or 'dots' (got "
                         f"{remat!r})")
    x = _embed(params, tokens, cfg)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_superblocks):
        if remat != "none":
            x, a = checkpoint(_superblock, params, x, i, cfg, positions,
                              block_lists, memory, use_reentrant=False,
                              context_fn=(_dots_context if remat == "dots"
                                          else noop_context_fn))
        else:
            x, a = _superblock(params, x, i, cfg, positions, block_lists,
                               memory)
        aux = aux + a
    logits = _logits(params, x, cfg)
    if extra_embeds is not None:
        logits = logits[:, extra_embeds.shape[1]:, :]
    return logits, aux


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig):
    """Whisper-style encoder over precomputed frame embeddings (the stub
    frontend): [B, S, d] -> [B, S, d] in the compute dtype."""
    x = frames.to(common.dtype_of(cfg.compute_dtype))
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    for i in range(cfg.n_enc_layers):
        p = _layer(params["encoder"], i)
        h = common.rms_norm(p["ln1"], x)
        x = x + attn_mod.attention(p["attn"], h, cfg, positions=positions,
                                   causal=False)
        x = x + mlp_mod.mlp(p["mlp"], common.rms_norm(p["ln2"], x))
    return common.rms_norm(params["enc_norm"], x)


def lm_loss(params: dict, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: ModelConfig, block_lists=None, extra_embeds=None,
            memory=None, aux_weight: float = 0.01):
    """Mean next-token cross-entropy over every position (f32), plus
    ``aux_weight`` times the MoE load-balancing loss."""
    logits, aux = forward(params, tokens, cfg, block_lists=block_lists,
                          extra_embeds=extra_embeds, memory=memory)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll) + aux_weight * aux


# =============================================================================
# decode (single token) against dense per-layer caches
# =============================================================================

def init_decode_caches(cfg: ModelConfig, batch: int, s_max: int, *,
                       device=None) -> list:
    """Per-super-block-position stacked caches, one dict per block kind:
    ``{"k", "v"}`` [n_sb, B, s_max, KVH, hd] (compute dtype) for attention,
    ``{"conv"}`` [n_sb, B, ssm_conv - 1, d_inner] (compute dtype) and
    ``{"h"}`` [n_sb, B, d_inner, ssm_state] (f32) for Mamba, ``{"x_tm",
    "x_cm"}`` [n_sb, B, d] (compute dtype) and ``{"S"}`` [n_sb, B, H, 64,
    64] (f32) for RWKV; all zeros on ``device`` (``None``: the card)."""
    dev = _device.resolve(device)
    cdt = common.dtype_of(cfg.compute_dtype)
    n_sb = cfg.n_superblocks
    d, hd, KVH = cfg.d_model, cfg.hd, cfg.n_kv_heads
    di, st = cfg.ssm_expand * d, cfg.ssm_state
    H_rwkv = d // rwkv_mod.HEAD_DIM

    def z(*shape, dtype=cdt):
        return torch.zeros((n_sb, batch, *shape), dtype=dtype, device=dev)
    caches = []
    for kind in cfg.block_kinds():
        if kind.startswith("attn"):
            caches.append({"k": z(s_max, KVH, hd), "v": z(s_max, KVH, hd)})
        elif kind.startswith("mamba"):
            caches.append({"conv": z(cfg.ssm_conv - 1, di),
                           "h": z(di, st, dtype=torch.float32)})
        elif kind == "rwkv":
            caches.append({"x_tm": z(d),
                           "S": z(H_rwkv, rwkv_mod.HEAD_DIM,
                                  rwkv_mod.HEAD_DIM, dtype=torch.float32),
                           "x_cm": z(d)})
        else:
            raise ValueError(kind)
    return caches


def _keep_rows(new: torch.Tensor, old: torch.Tensor, write):
    """``new`` on the rows ``write`` selects (all when None), ``old``
    elsewhere; rows are dim 0."""
    if write is None:
        return new
    sel = write.to(new.device).reshape(-1, *([1] * (new.dim() - 1)))
    return torch.where(sel, new.to(old.dtype), old)


def decode_step(params: dict, caches: list, tokens: torch.Tensor,
                pos: torch.Tensor, cfg: ModelConfig,
                memory: Optional[torch.Tensor] = None,
                write: Optional[torch.Tensor] = None):
    """tokens: int[B, 1]; pos: int[B] -> (logits [B, 1, V], caches).

    The serving step of every pattern, over ``init_decode_caches``'
    caches, which are updated **in place** (the reference returns new
    ones) and returned. ``memory``: the encoder output (encoder-decoder).
    ``write`` (bool[B]; default every row, the reference's behaviour)
    selects the rows that advance: a row left out stores no K/V, attends
    to positions ``< pos`` and keeps its Mamba / RWKV state, as a row of
    ``decode_step_paged`` that does not write.
    """
    x = _embed(params, tokens, cfg)
    for i in range(cfg.n_superblocks):
        for j, kind in enumerate(cfg.block_kinds()):
            p, c = _layer(params["blocks"][j], i), caches[j]
            h = common.rms_norm(p["ln1"], x)
            if kind.startswith("attn"):
                out, _, _ = attn_mod.attention_decode(
                    p["attn"], h, cfg, cache_k=c["k"][i], cache_v=c["v"][i],
                    pos=pos, layer_kind=kind, write=write)
                x = x + out
            elif kind.startswith("mamba"):
                out, (nc, nh) = ssm_mod.mamba_decode_step(
                    p["mamba"], h, (c["conv"][i], c["h"][i]), cfg)
                c["conv"][i] = _keep_rows(nc, c["conv"][i], write)
                c["h"][i] = _keep_rows(nh, c["h"][i], write)
                x = x + out
            elif kind == "rwkv":
                out, (x_tm, S, _) = rwkv_mod.rwkv_decode_step(
                    p["tm"], h, (c["x_tm"][i], c["S"][i], c["x_cm"][i]), cfg)
                x = x + out
                h2 = common.rms_norm(p["ln2"], x)
                cm_out, x_cm = rwkv_mod.rwkv_channel_mix_step(
                    p["tm"], h2, c["x_cm"][i], cfg)
                x = x + cm_out
                for k, v in (("x_tm", x_tm), ("S", S), ("x_cm", x_cm)):
                    c[k][i] = _keep_rows(v, c[k][i], write)
                continue
            h2 = common.rms_norm(p["ln2"], x)
            if kind.endswith("_moe"):
                x = x + mlp_mod.moe(p["moe"], h2, cfg)[0]
            else:
                x = x + mlp_mod.mlp(p["mlp"], h2)
        if cfg.layer_pattern == "encdec" and memory is not None:
            cp = _layer(params["cross"], i)
            h = common.rms_norm(cp["ln"], x)
            x = x + attn_mod.cross_attention(cp["xattn"], h, memory, cfg)
    return _logits(params, x, cfg), caches


# =============================================================================
# decode against the Roaring-paged KV cache (serving path)
# =============================================================================

def _check_paged(cfg: ModelConfig) -> None:
    if not all(k.startswith("attn") for k in cfg.block_kinds()):
        raise ValueError(
            f"{cfg.name}: paged decode supports attention-only patterns; use "
            f"decode_step for {cfg.layer_pattern!r}")


def init_paged_caches(cfg: ModelConfig, n_pages: int, page_size: int, *,
                      device=None) -> list:
    """Per-super-block-position stacked page pools, one ``{"k", "v"}`` per
    block kind, each ``[n_superblocks, n_pages, page_size, KVH, hd]`` in the
    compute dtype (attention-only patterns)."""
    _check_paged(cfg)
    dev = _device.resolve(device)
    cdt = common.dtype_of(cfg.compute_dtype)
    shape = (cfg.n_superblocks, n_pages, page_size, cfg.n_kv_heads, cfg.hd)
    return [{"k": torch.zeros(shape, dtype=cdt, device=dev),
             "v": torch.zeros(shape, dtype=cdt, device=dev)}
            for _ in cfg.block_kinds()]


def decode_step_paged(params: dict, pools: list, tokens: torch.Tensor,
                      pos: torch.Tensor, page_idx: torch.Tensor,
                      counts: torch.Tensor, lengths: torch.Tensor,
                      cfg: ModelConfig, write: Optional[torch.Tensor] = None):
    """Decode one token against Roaring-paged KV pools (attention-only
    patterns; MoE on ``attn_moe`` kinds; the encoder-decoder pattern without
    memory, as in the reference).

    tokens: int[B, 1]; pos: int[B]; page_idx: int32[B, max_pages] physical
    page list per sequence (``RoaringPageTable.gather_lists``); counts /
    lengths: int32[B]. Returns ``(logits, pools)``.

    The pools are updated **in place** (the reference returns new pools
    built with ``.at[].set``) and the same list is returned. ``write``
    (bool[B], any device) selects the rows whose K/V lands in the pools;
    the default, every row, is the reference's behaviour. A row that is not
    advancing must not write: its next position may start a page it does
    not own yet, where ``page_idx`` holds the zero padding, and the write
    would land on physical page 0 of another sequence.
    """
    from repro_torch.kernels.sparse_attn import paged_decode

    _check_paged(cfg)
    x = _embed(params, tokens, cfg)
    B = tokens.shape[0]
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // KVH
    page_size = pools[0]["k"].shape[2]
    pos = pos.long()
    # physical page + in-page offset where this token's KV lands (the
    # logical page is clamped, as the reference's gather clamps it)
    logical = torch.clamp(pos // page_size, max=page_idx.shape[1] - 1)
    phys = page_idx.long().gather(1, logical[:, None])[:, 0]
    offs = pos % page_size
    rows = (torch.arange(B, device=x.device) if write is None
            else torch.nonzero(write).flatten().to(x.device))
    phys, offs = phys[rows], offs[rows]
    kv_len = (lengths + 1).to(torch.int32)
    starts_local = torch.clamp(pos + 1 - cfg.window, min=0).to(torch.int32)
    starts_global = torch.zeros_like(starts_local)
    for i in range(cfg.n_superblocks):
        for j, kind in enumerate(cfg.block_kinds()):
            p = _layer(params["blocks"][j], i)
            pk, pv = pools[j]["k"][i], pools[j]["v"][i]
            h = common.rms_norm(p["ln1"], x)
            q, k, v = attn_mod._project_qkv(p["attn"], h, cfg, pos[:, None])
            pk[phys, offs] = k[rows, 0].to(pk.dtype)
            pv[phys, offs] = v[rows, 0].to(pv.dtype)
            starts = starts_local if "local" in kind else starts_global
            out = paged_decode(q.reshape(B, KVH, G, hd), pk, pv, page_idx,
                               counts, kv_len, starts,
                               softcap=cfg.attn_softcap)
            out = out.reshape(B, 1, H, hd)
            x = x + torch.einsum("bshk,hkd->bsd", out.to(x.dtype),
                                 p["attn"]["wo"].to(x.dtype))
            h2 = common.rms_norm(p["ln2"], x)
            if kind.endswith("_moe"):
                x = x + mlp_mod.moe(p["moe"], h2, cfg)[0]
            else:
                x = x + mlp_mod.mlp(p["mlp"], h2)
    return _logits(params, x, cfg), pools
