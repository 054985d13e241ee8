"""The LM for attention-only layer patterns: init, ``forward`` (training
and teacher-forced), ``lm_loss``, and decode against the Roaring-paged KV
cache.

Layers are stacked per *super-block* as in the reference: ``params
["blocks"]`` holds one dict per block kind of the super-block, each leaf
with a leading ``n_superblocks`` axis, and a Python loop over super-blocks
takes the place of the reference's ``lax.scan``; ``remat="full"``
checkpoints each super-block, as the reference checkpoints its scan body.
Patterns with MoE, SSM, RWKV or an encoder wait for later slices (ROADMAP
queue 1) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import _device

from . import attention as attn_mod
from . import common, mlp as mlp_mod
from .config import ModelConfig


def check_supported(cfg: ModelConfig) -> None:
    kinds = cfg.block_kinds()
    if cfg.layer_pattern == "encdec" or not all(
            k in ("attn_mlp", "attn_local_mlp") for k in kinds):
        raise NotImplementedError(
            f"{cfg.name}: layer pattern {cfg.layer_pattern!r} is not ported "
            "yet (attention + dense MLP only); see ROADMAP.md queue 1")


def _layer(tree, i: int):
    """The ``i``-th super-block's view of a stacked parameter or pool tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _sqrt_d(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """gemma-style sqrt(d) embedding scale, rounded to the compute dtype."""
    return torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                        device=x.device)


# =============================================================================
# init
# =============================================================================

def init_lm(cfg: ModelConfig, seed: int = 0, *, device=None) -> dict:
    """Random parameters from one explicit ``torch.Generator`` seeded with
    ``seed``, drawn on ``device`` (``None``: the card). Truncated normals
    with the reference's scales; the numbers differ from the reference's
    ``jax.random`` draws (tests carry the reference's parameters over with
    ``models.convert`` instead)."""
    check_supported(cfg)
    dev = _device.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
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
    params["blocks"] = [{
        "ln1": common.rms_norm_init(d, torch.float32, device=dev, stack=n_sb),
        "ln2": common.rms_norm_init(d, torch.float32, device=dev, stack=n_sb),
        "attn": attn_mod.attn_init(cfg, dtype, generator=gen, stack=n_sb),
        "mlp": mlp_mod.mlp_init(cfg, dtype, generator=gen, stack=n_sb),
    } for _ in cfg.block_kinds()]
    return params


# =============================================================================
# forward (training, teacher-forced, prefill)
# =============================================================================

def _superblock(params: dict, x: torch.Tensor, i: int, cfg: ModelConfig,
                positions, block_lists) -> torch.Tensor:
    for j, kind in enumerate(cfg.block_kinds()):
        p = _layer(params["blocks"][j], i)
        h = common.rms_norm(p["ln1"], x)
        x = x + attn_mod.attention(p["attn"], h, cfg, positions=positions,
                                   layer_kind=kind, block_lists=block_lists)
        x = x + mlp_mod.mlp(p["mlp"], common.rms_norm(p["ln2"], x))
    return x


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            block_lists=None, remat: str = "none"):
    """tokens: int[B, S] -> (logits [B, S, V], aux_loss).

    Attention-only patterns, so ``aux_loss`` is always 0. ``block_lists``:
    optional (kv_idx, counts) tensors on the tokens' device for the Roaring
    block-sparse path of global layers (``cfg.attn_impl == "sparse"``).
    ``remat``: "none" or "full" (each super-block is recomputed in the
    backward, so only super-block inputs are kept); the reference's "dots"
    policy is not ported yet.
    """
    check_supported(cfg)
    if remat == "dots":
        raise NotImplementedError('remat="dots" (save only matmul outputs) '
                                  "is not ported yet; see ROADMAP.md queue 1")
    if remat not in ("none", "full"):
        raise ValueError(f"remat must be 'none' or 'full' (got {remat!r})")
    cdt = common.dtype_of(cfg.compute_dtype)
    x = common.embed(params["embed"], tokens).to(cdt)
    if cfg.logit_softcap is not None:           # gemma-style sqrt(d) scaling
        x = x * _sqrt_d(cfg, x)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    for i in range(cfg.n_superblocks):
        if remat == "full":
            x = checkpoint(_superblock, params, x, i, cfg, positions,
                           block_lists, use_reentrant=False)
        else:
            x = _superblock(params, x, i, cfg, positions, block_lists)
    x = common.rms_norm(params["final_norm"], x)
    table = params["unembed"] if not cfg.tie_embeddings else params["embed"]
    logits = common.unembed(table, x, softcap=cfg.logit_softcap,
                            vocab=cfg.vocab)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def lm_loss(params: dict, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: ModelConfig, block_lists=None, aux_weight: float = 0.01):
    """Mean next-token cross-entropy over every position (f32)."""
    logits, aux = forward(params, tokens, cfg, block_lists=block_lists)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll) + aux_weight * aux


# =============================================================================
# decode against the Roaring-paged KV cache (serving path)
# =============================================================================

def init_paged_caches(cfg: ModelConfig, n_pages: int, page_size: int, *,
                      device=None) -> list:
    """Per-super-block-position stacked page pools, one ``{"k", "v"}`` per
    block kind, each ``[n_superblocks, n_pages, page_size, KVH, hd]`` in the
    compute dtype."""
    check_supported(cfg)
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
    """Decode one token against Roaring-paged KV pools.

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

    check_supported(cfg)
    cdt = common.dtype_of(cfg.compute_dtype)
    x = common.embed(params["embed"], tokens).to(cdt)
    if cfg.logit_softcap is not None:
        x = x * _sqrt_d(cfg, x)
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
    kinds = cfg.block_kinds()
    for i in range(cfg.n_superblocks):
        for j, kind in enumerate(kinds):
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
            x = x + mlp_mod.mlp(p["mlp"], common.rms_norm(p["ln2"], x))
    x = common.rms_norm(params["final_norm"], x)
    table = params["unembed"] if not cfg.tie_embeddings else params["embed"]
    logits = common.unembed(table, x, softcap=cfg.logit_softcap,
                            vocab=cfg.vocab)
    return logits, pools
