"""The registry's architectures on the card, against the same calls on the
CPU.

The module skips as a whole without a CUDA card, so that a machine without
one collects none of its tests. Run them on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_archs.py

This file imports no JAX: the machine with the card has none. Every
reduced config runs in float32 compute (TF32 off) from the same
parameters on both devices; sums taken in another order on another device
agree to ``ATOL`` / ``RTOL`` through a few layers. MoE routing is compared
exactly on inputs without near-ties.
"""

import dataclasses

import numpy as np
import pytest
import torch

if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA card (run on the chip)",
                allow_module_level=True)

from repro_torch._tree import tree_map  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels.sparse_attn import kernel as SK  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import mlp as PM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

pytestmark = pytest.mark.gpu

SEED = 1419
ATOL, RTOL = 1e-4, 1e-3


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _close(got, want, what):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=ATOL,
                               rtol=RTOL, err_msg=what)


def _paged_inputs(rng, cfg, page=4):
    pos = np.asarray([6, 13], np.int32)
    counts = (pos // page + 1).astype(np.int32)
    P = int(counts.sum()) + 3
    perm = rng.permutation(P)
    page_idx = np.zeros((2, 8), np.int32)
    page_idx[0, :counts[0]] = perm[:counts[0]]
    page_idx[1, :counts[1]] = perm[counts[0]:counts.sum()]
    pools = [{k: rng.standard_normal(
        (cfg.n_superblocks, P, page, cfg.n_kv_heads, cfg.hd)).astype(
            np.float32) for k in ("k", "v")} for _ in cfg.block_kinds()]
    tok = rng.integers(0, cfg.vocab, (2, 1))
    return pools, tok, pos, page_idx, counts


@pytest.mark.parametrize("arch", list_archs())
def test_reduced_config_on_card_matches_cpu(arch):
    """``forward`` (vision: stub patches; encoder-decoder: ``encode``'s
    memory), two ``decode_step`` calls and, on attention-only patterns,
    one ``decode_step_paged`` through the paged decode kernel."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype="float32")
    rng = np.random.default_rng(SEED)
    cpu = T.init_lm(cfg, SEED, device="cpu")
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12)))
    extra = frames = None
    if cfg.frontend == "vision":
        extra = torch.from_numpy(rng.standard_normal(
            (2, 6, cfg.d_model)).astype(np.float32))
    if cfg.layer_pattern == "encdec":
        frames = torch.from_numpy(rng.standard_normal(
            (2, 10, cfg.d_model)).astype(np.float32))
    paged = all(k.startswith("attn") for k in cfg.block_kinds())
    pools, tok, pos, page_idx, counts = _paged_inputs(rng, cfg)
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), cpu)
        mem = None if frames is None else T.encode(p, frames.to(dev), cfg)
        ex = None if extra is None else extra.to(dev)
        logits, aux = T.forward(p, tokens.to(dev), cfg, extra_embeds=ex,
                                memory=mem)
        res = [logits, aux] + ([] if mem is None else [mem])
        caches = T.init_decode_caches(cfg, 2, 8, device=dev)
        for s in range(2):
            lg, caches = T.decode_step(
                p, caches, tokens[:, s:s + 1].to(dev),
                torch.tensor([1 + s, 6 + s], device=dev), cfg, memory=mem)
            res.append(lg)
        res += [t for c in caches for t in c.values()]
        if paged:
            SK.reset_launch_counts()
            lg, _ = T.decode_step_paged(
                p, [{k: torch.from_numpy(v).to(dev) for k, v in c.items()}
                    for c in pools], torch.from_numpy(tok).to(dev),
                *(torch.from_numpy(a).to(dev) for a in (pos, page_idx,
                                                        counts, pos)), cfg)
            res.append(lg)
            assert SK.launch_counts["paged_decode"] == (
                cfg.n_layers if dev == "cuda" else 0)
        out[dev] = res
    assert len(out["cuda"]) == len(out["cpu"])
    for i, (g, w) in enumerate(zip(out["cuda"], out["cpu"])):
        _close(g, w, f"{arch} result {i}")


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-maverick-400b-a17b",
                                  "jamba-1.5-large-398b"])
def test_moe_routing_on_card_matches_cpu(arch):
    """Gate indices, capacity slots and keep mask exactly; router columns 0
    and 1 zeroed, so their probabilities tie and the lower index wins."""
    cfg = get_config(arch, reduced=True)
    gen = torch.Generator().manual_seed(SEED)
    router = torch.randn((cfg.d_model, cfg.n_experts), generator=gen)
    router[:, :2] = 0
    x = torch.randn((64, cfg.d_model), generator=gen)
    cpu = PM.route(router, x, cfg)
    card = PM.route(router.cuda(), x.cuda(), cfg)
    for i in (2, 3, 4):
        assert torch.equal(card[i].cpu(), cpu[i]), i
    assert card[5] == cpu[5]
    if cfg.top_k > 1:
        idx = cpu[2]
        assert ((idx[:, :-1] == 0) & (idx[:, 1:] == 1)).any()
        assert not ((idx[:, :-1] == 1) & (idx[:, 1:] == 0)).any()


def test_dense_init_draws_bf16_leaves_in_slices(monkeypatch):
    """A bf16 leaf is drawn in float32 slices, so the peak stays near the
    bf16 result: no float32 copy of the whole leaf; the values keep the
    truncated normal's range and scale."""
    monkeypatch.setattr(common, "_DRAW_ELEMS", 1 << 22)
    shape = (8, 1024, 2048)                 # stack 4: 64 M elements
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    w = common.dense_init(shape, torch.bfloat16, generator=gen, stack=4)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    n = w.numel()
    assert w.dtype == torch.bfloat16 and w.shape == (4, *shape)
    # the bf16 result and at most three float32 slices of 16 MB (a slice
    # is allocated before the previous one is freed); the whole leaf in
    # float32 would be 256 MB more
    assert peak <= 2 * n + 3 * 4 * (1 << 22), peak
    std = 1.0 / np.sqrt(shape[0])
    wf = w.float()
    assert float(wf.abs().max()) <= 2 * std * (1 + 2 ** -7)
    # a normal cut at +-2: standard deviation 0.8796 of the uncut one
    assert abs(float(wf.std()) / std - 0.8796) < 0.01
    assert abs(float(wf.mean())) < 1e-3 * std * 10
