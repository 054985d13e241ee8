"""The block-sparse flash CUDA kernel and the train step, on the card:
the kernel over its grid and the registry's training pairs (G, D), gemma2's
train step, and two train steps of every reduced config of the registry
against the CPU.

The module skips as a whole without a CUDA card, so that a machine without
one collects none of its tests. Run them on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_train.py

This file imports no JAX: the machine with the card has none.
Tolerances: a bfloat16 output differs from its plain version by at most
one rounding of the output (one ulp is 2**-7 below magnitude 2, and the
case outputs are weighted means of standard normals), so ``BF16_ATOL`` is
1e-2; in float32 the sums differ only in order (``F32_ATOL``). The train
step on the card and on the CPU run in float32 with TF32 off; their loss,
grad norm and parameters agree to ``STEP_RTOL`` / ``STEP_ATOL``. The
registry's reduced configs train with ``pick_optimizer``'s optimizer (8-bit
AdamW on stablelm-1.6b, remat "dots" on dbrx) at a constant learning rate;
over more kinds of layers (Mamba and RWKV scans, MoE routing) their card
and CPU runs are held to the registry rule, ``REG_ATOL`` + ``REG_RTOL`` x
|value|, as ``chip_smoke.py`` holds them.
"""

import dataclasses

import numpy as np
import pytest
import torch

if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA card (run on the chip)",
                allow_module_level=True)

from repro_torch import _tree  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels.sparse_attn import cases  # noqa: E402
from repro_torch.kernels.sparse_attn import kernel as SK  # noqa: E402
from repro_torch.kernels.sparse_attn import ref as SR  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw, cosine_schedule  # noqa: E402
from repro_torch.sparsity import build_arch_mask, compile_mask  # noqa: E402
from repro_torch.train import TrainState, make_train_step  # noqa: E402

pytestmark = pytest.mark.gpu

SEED = 1402
BF16_ATOL = 1e-2
F32_ATOL = 1e-5
STEP_RTOL, STEP_ATOL = 1e-4, 1e-6
REG_ATOL, REG_RTOL = 1e-4, 1e-3


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G,D,softcap,causal",
                         cases.FLASH_GRID + cases.FLASH_REGISTRY_GRID)
def test_sparse_flash_kernel_matches_plain_version(G, D, softcap, causal,
                                                   dtype):
    c = cases.sparse_flash_case(np.random.default_rng(SEED), G, D)
    t = {k: torch.from_numpy(v).cuda() for k, v in c.items()}
    q, k, v = (t[n].to(dtype) for n in "qkv")
    opts = dict(causal=causal, softcap=softcap)
    got = SK.sparse_flash_attention_cuda(q, k, v, t["kv_idx"], t["counts"],
                                         **opts)
    torch.cuda.synchronize()
    want = SR.sparse_attention_ref(q, k, v, t["kv_idx"], t["counts"], **opts)
    assert got.dtype == dtype and torch.isfinite(got).all()
    if causal:                  # row 0 lists only a future block
        assert not got[:, :, :cases.FLASH_BLOCK].any()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= (BF16_ATOL if dtype == torch.bfloat16 else F32_ATOL), err


@pytest.mark.parametrize("softcap", [None, 50.0])
def test_sparse_flash_kernel_bf16_train_shape(softcap):
    """The bf16 tensor-core kernel at gemma2's head dim and GQA pair (D =
    256, G = 2, S = 2048, block 128) over random causal block lists, held
    to its plain version within one bf16 rounding of each output (one ulp
    is at most 2**-7 of the larger magnitude), as ``chip_smoke.py`` holds
    the training path's launch."""
    c = cases.sparse_flash_random_case(np.random.default_rng(SEED), 2, 256,
                                       2048)
    t = {k: torch.from_numpy(v).cuda() for k, v in c.items()}
    q, k, v = (t[n].to(torch.bfloat16) for n in "qkv")
    got = SK.sparse_flash_attention_cuda(q, k, v, t["kv_idx"], t["counts"],
                                         softcap=softcap)
    torch.cuda.synchronize()
    want = SR.sparse_attention_ref(q, k, v, t["kv_idx"], t["counts"],
                                   softcap=softcap)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    diff = (got.float() - want.float()).abs()
    ulp = 2.0 ** -7 * torch.maximum(got.float().abs(), want.float().abs())
    assert not (diff > ulp + F32_ATOL).any(), diff.max().item()


def test_train_step_on_card_matches_cpu():
    """Reduced gemma2-2b with Roaring block-sparse global layers, float32
    compute, remat: two AdamW steps on the card (through the kernel, two
    launches per global layer per step) and on the CPU (the plain
    version) agree."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("gemma2-2b", reduced=True),
                              compute_dtype="float32", attn_impl="sparse")
    S, B = 512, 2
    lists = compile_mask(build_arch_mask(S // cfg.sparse_block,
                                         pattern="local_global",
                                         window_blocks=2, n_global=1))
    rng = np.random.default_rng(SEED)
    batches = [{"tokens": rng.integers(1, cfg.vocab, (B, S + 1)).astype(
        np.int32), "mask": np.ones((B, S + 1), np.float32)}
        for _ in range(2)]
    params = T.init_lm(cfg, SEED, device="cpu")
    got = {}
    for dev in ("cpu", "cuda"):
        p = _tree.tree_map(lambda x: x.detach().to(dev, copy=True), params)
        opt = adamw(cosine_schedule(1e-3, warmup=1, total=4))
        state = TrainState(p, opt.init(p), 0)
        step = make_train_step(cfg, opt, remat="full", block_lists=lists)
        SK.reset_launch_counts()
        metrics = []
        for batch in batches:
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        if dev == "cuda":
            assert SK.launch_counts["sparse_flash_attention"] == (
                2 * cfg.n_superblocks * len(batches))
        got[dev] = (metrics, [x.detach().cpu()
                              for x in _tree.leaves(state["params"])])
    np.testing.assert_allclose(got["cuda"][0], got["cpu"][0],
                               rtol=STEP_RTOL)
    for a, b in zip(got["cuda"][1], got["cpu"][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=STEP_RTOL,
                                   atol=STEP_ATOL)


@pytest.mark.parametrize("arch,memory", [(a, False) for a in list_archs()]
                         + [("whisper-base", True)])
def test_registry_train_steps_on_card_match_cpu(arch, memory):
    """Two train steps of a reduced config, float32 compute, block-sparse
    wherever it has attention (head dim 16), on the card and on the CPU from
    the same state: qwen2-vl with 64 stub patches, whisper with 256 frames
    of memory or without; two kernel launches a block-sparse layer a step
    on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype="float32")
    sparse = any(k.startswith("attn") for k in cfg.block_kinds())
    if sparse:
        cfg = dataclasses.replace(cfg, attn_impl="sparse")
    S = 256
    lists = (compile_mask(build_arch_mask(S // cfg.sparse_block,
                                          pattern="local_global",
                                          window_blocks=1, n_global=1))
             if sparse else None)
    rng = np.random.default_rng(SEED)
    n_extra = specs.VIS_TOKENS if cfg.frontend == "vision" else 0
    batches = []
    for _ in range(2):
        b = {"tokens": rng.integers(1, cfg.vocab, (2, S - n_extra + 1)),
             "mask": np.ones((2, S - n_extra + 1), np.float32)}
        if n_extra:
            b["extra_embeds"] = rng.standard_normal(
                (2, n_extra, cfg.d_model)).astype(np.float32)
        if memory:
            b["memory"] = rng.standard_normal(
                (2, specs.ENC_FRAMES, cfg.d_model)).astype(np.float32)
        batches.append(b)
    name = ("adamw8bit" if arch == "stablelm-1.6b"
            else specs.pick_optimizer(get_config(arch)).name)
    remat = "dots" if arch == "dbrx-132b" else "full"
    params = T.init_lm(cfg, SEED, device="cpu")
    got = {}
    for dev in ("cpu", "cuda"):
        p = _tree.tree_map(lambda x: x.detach().to(dev, copy=True), params)
        opt = getattr(optim, name)(1e-3)
        state = TrainState(p, opt.init(p), 0)
        step = make_train_step(cfg, opt, remat=remat, block_lists=lists)
        SK.reset_launch_counts()
        metrics = []
        for batch in batches:
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        if dev == "cuda":
            n_global = sum(k.startswith("attn") and "local" not in k
                           for k in cfg.block_kinds())
            assert SK.launch_counts["sparse_flash_attention"] == (
                2 * cfg.n_superblocks * n_global * len(batches) * sparse)
        got[dev] = (metrics, [x.detach().cpu()
                              for x in _tree.leaves(state["params"])])
    assert np.all(np.isfinite(got["cuda"][0]))
    np.testing.assert_allclose(got["cuda"][0], got["cpu"][0],
                               atol=REG_ATOL, rtol=REG_RTOL)
    for a, b in zip(got["cuda"][1], got["cpu"][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=REG_ATOL,
                                   rtol=REG_RTOL)
