"""The paged-decode CUDA kernel and the serving engine, on the card.

The module skips as a whole without a CUDA card, so that a machine without
one collects none of its tests. Run them on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_serve.py

This file imports no JAX: the machine with the card has none.
Tolerances: a bfloat16 output differs from its plain version by at most
one rounding of the output (one ulp is 2**-7 below magnitude 2, and the
case outputs are weighted means of standard normals), so ``BF16_ATOL`` is
1e-2; in float32 the sums differ only in order (``F32_ATOL``). The
long-split case's rows of thousands of positions give outputs near
0.02-0.1, so there each bfloat16 output vector is held within
``RING_ULPS`` bf16 ulps of its own largest element.
"""

import dataclasses

import numpy as np
import pytest
import torch

if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA card (run on the chip)",
                allow_module_level=True)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.sparse_attn import cases  # noqa: E402
from repro_torch.kernels.sparse_attn import kernel as SK  # noqa: E402
from repro_torch.kernels.sparse_attn import ref as SR  # noqa: E402
from repro_torch.launch.serve import make_requests, serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

pytestmark = pytest.mark.gpu

SEED = 1402
BF16_ATOL = 1e-2
F32_ATOL = 1e-5
RING_ULPS = 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G,D,page,softcap,KVH", cases.CHECK_GRID)
@pytest.mark.parametrize("make", [cases.paged_decode_case,
                                  cases.paged_decode_split_case],
                         ids=["pages", "splits"])
def test_paged_decode_kernel_matches_plain_version(make, G, D, page, softcap,
                                                   KVH, dtype):
    """Both case layouts: rows with ``starts > 0``, an empty row and NaN
    pages after ``counts``; and rows on the kernel's split boundaries (a
    window starting past the first split, a length ending one position
    into a split, ``counts = 0``, ``starts >= lengths``)."""
    c = make(np.random.default_rng(SEED), G, D, page, KVH=KVH)
    if make is cases.paged_decode_split_case:
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        assert SK.decode_split(SK.decode_rows(*c["q"].shape, dtype),
                               c["page_idx"].shape[1] * page,
                               n_sm) == cases.DECODE_SPLIT
    t = {k: torch.from_numpy(v).cuda() for k, v in c.items()}
    q, kp, vp = (t[k].to(dtype) for k in ("q", "k_pages", "v_pages"))
    args = tuple(t[k] for k in ("page_idx", "counts", "lengths", "starts"))
    got = SK.paged_decode_cuda(q, kp, vp, *args, softcap=softcap)
    torch.cuda.synchronize()
    want = SR.paged_decode_ref(q, kp, vp, *args, softcap=softcap)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert not got[torch.from_numpy(cases.no_live_position(c)).cuda()].any()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= (BF16_ATOL if dtype == torch.bfloat16 else F32_ATOL), err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G,D,page,softcap,KVH", cases.RING_GRID)
def test_paged_decode_kernel_refills_its_ring(G, D, page, softcap, KVH,
                                              dtype):
    """The long-split layout: the kernel's longest split, so every warp
    walks many more tiles than its ring of copies holds. The plain version
    gets the page lists cut after the longest row's ``counts`` (the same
    function)."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = SK.decode_rows(4, KVH, G, D, dtype)
    max_pages = cases.ring_max_pages(rows, SK.DECODE_BLOCKS_PER_SM * n_sm,
                                     page)
    c = cases.paged_decode_ring_case(np.random.default_rng(SEED), G, D, page,
                                     KVH=KVH, max_pages=max_pages)
    assert SK.decode_split(rows, max_pages * page, n_sm) == cases.RING_SPLIT
    t = {k: torch.from_numpy(v).cuda() for k, v in c.items()}
    q, kp, vp = (t[k].to(dtype) for k in ("q", "k_pages", "v_pages"))
    args = tuple(t[k] for k in ("page_idx", "counts", "lengths", "starts"))
    cut = int(c["counts"].max())
    short = (t["page_idx"][:, :cut].contiguous(),) + args[1:]
    got = SK.paged_decode_cuda(q, kp, vp, *args, softcap=softcap)
    torch.cuda.synchronize()
    want = SR.paged_decode_ref(q, kp, vp, *short, softcap=softcap).float()
    assert got.dtype == dtype and torch.isfinite(got).all()
    diff = (got.float() - want).abs()
    if dtype == torch.bfloat16:
        top = want.abs().amax(-1, keepdim=True)
        assert bool((top > 0).all())
        tol = RING_ULPS * torch.exp2(torch.floor(torch.log2(top)) - 7)
    else:
        tol = F32_ATOL
    assert bool((diff <= tol).all()), diff.max().item()


@pytest.mark.parametrize("arch", ["gemma2-2b", "stablelm-1.6b"])
def test_engine_on_card_matches_cpu(arch):
    """Reduced config, float32 compute: the engine on the card serves the
    tokens the engine on the CPU serves, with ``paged_decode`` launched
    once per layer per step."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype="float32")
    params = T.init_lm(cfg, SEED, device="cpu")
    got = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else _to(params, dev)
        eng = ServeEngine(cfg, p, max_batch=3, n_pages=64, page_size=4,
                          max_pages_per_seq=24, device=dev)
        reqs = make_requests(cfg, 5, 8, SEED)
        SK.reset_launch_counts()
        serve(eng, reqs)
        got[dev] = [r.generated for r in reqs]
        if dev == "cuda":
            assert SK.launch_counts["paged_decode"] == (
                cfg.n_layers * eng.steps_run)
        assert eng.table.utilization() == 0.0
    assert got["cuda"] == got["cpu"]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)
