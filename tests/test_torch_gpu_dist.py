"""Roaring gradient compression and sharded search on the card.

The module skips as a whole without a CUDA card, so that a machine without
one collects none of its tests. Run them on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_dist.py

This file imports no JAX: the machine with the card has none. The CPU port
is the reference here (``tests/_torch_distributed.py`` holds it to the
JAX package); every check is exact.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA card (run on the chip)",
                allow_module_level=True)

import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402

from repro_torch import grad_comp as GC  # noqa: E402
from repro_torch import roaring as RS  # noqa: E402
from repro_torch import search as S  # noqa: E402
from repro_torch.distributed import context  # noqa: E402
from repro_torch.kernels.roaring import kernel as K  # noqa: E402

pytestmark = pytest.mark.gpu

SEED = 1402
N_DOCS = 1_000_000


@pytest.fixture(scope="module")
def nccl():
    """A one-rank NCCL group through a file store, for the module."""
    fd, path = tempfile.mkstemp(prefix="gpu-dist-")
    os.close(fd)
    os.remove(path)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{path}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()
    if os.path.exists(path):
        os.remove(path)


def _leaves():
    rng = np.random.default_rng(SEED)
    hot = (rng.standard_normal(7 * 65536) * 1e-3).astype(np.float32)
    hot[70_000:80_000] = rng.standard_normal(10_000) + 10.0
    zeros = np.zeros(50_000, np.float32)
    zeros[rng.choice(50_000, 40, replace=False)] = 1.0
    levels = rng.integers(-3, 4, 200_000).astype(np.float32) * 0.5
    return [rng.standard_normal((1000, 3000)).astype(np.float32), hot,
            zeros, levels]


def _k(g):
    return max(64, int(np.ceil(g.size * 0.01)))


def test_compress_leaf_on_card_matches_cpu():
    for g in _leaves():
        c = GC.compress_leaf(torch.from_numpy(g), _k(g))
        d = GC.compress_leaf(torch.from_numpy(g).cuda(), _k(g))
        assert d.slab.device.type == "cuda"
        assert d.slab.serialize() == c.slab.serialize()
        assert torch.equal(d.values.cpu(), c.values)
        assert torch.equal(
            GC.decompress_leaf(d, g.shape, torch.float32).cpu(),
            GC.decompress_leaf(c, g.shape, torch.float32))
    # overlaps through the kernels against the CPU port (the levels leaf
    # against shifted copies of itself)
    lv = _leaves()[3]
    steps = [np.roll(lv, s) for s in (0, 7, 5000)]
    cs = [GC.compress_leaf(torch.from_numpy(x), _k(x)) for x in steps]
    ds = [GC.compress_leaf(torch.from_numpy(x).cuda(), _k(x)) for x in steps]
    K.reset_launch_counts()
    assert int(GC.leaf_overlap(ds[0], ds[1])) == \
        int(GC.leaf_overlap(cs[0], cs[1]))
    assert float(GC.leaf_jaccard(ds[0], ds[2])) == \
        float(GC.leaf_jaccard(cs[0], cs[2]))
    assert torch.equal(GC.leaf_overlap_many(ds[0], ds[1:]).cpu(),
                       GC.leaf_overlap_many(cs[0], cs[1:]))
    assert K.launch_counts["intersect_dispatch"] > 0
    assert K.launch_counts["intersect_dispatch_stacked"] == 1


def test_compressed_mean_on_nccl_mesh_matches_cpu(nccl):
    mesh = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("pod",))
    leaves = _leaves()
    grads = [torch.from_numpy(g).cuda() for g in leaves]
    with context.data_axes(("pod",), 1, None, mesh=mesh):
        out = GC.compressed_crosspod_mean(grads, axis_name="pod")
    for got, g in zip(out, leaves):
        want = GC.decompress_leaf(GC.compress_leaf(torch.from_numpy(g),
                                                   _k(g)),
                                  g.shape, torch.float32)
        assert torch.equal(got.cpu(), want)


def test_sharded_topk_on_nccl_mesh_matches_local(nccl):
    rng = np.random.default_rng(SEED + 1)
    postings = {f"t{i:03d}": np.unique(rng.integers(
        0, N_DOCS, max(4, int(0.3 * N_DOCS * (i + 1) ** -1.1))))
        for i in range(64)}
    index = S.PostingIndex.from_postings(postings, N_DOCS)
    mesh = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("data",))
    sharded = index.shard(mesh)
    K.reset_launch_counts()
    for i in range(8):
        q = np.unique(rng.integers(0, N_DOCS, 20_000 * (i + 1)))
        qs = RS.RoaringSlab.from_values(q, index.C, q.size)
        for k in (5, index.n_rows):
            a, b = index.topk(qs, k), sharded.topk(qs, k)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert K.launch_counts["intersect_dispatch_stacked"] == 32
