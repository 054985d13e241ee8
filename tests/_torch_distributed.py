"""Port parity checks: Roaring gradient compression and the distributed
layer.

The tier-1 run reaches them through existing items, because each CPU item
the suite adds moves xdist's first chunks and crashes a worker of
``test_dispatch.py`` (ROADMAP queue 3d): ``check_grad_comp`` runs in
``test_torch_train.py::test_train_steps_match_reference``,
``check_two_rank_training`` in
``test_torch_train.py::test_resilient_training_matches_uninterrupted`` and
``check_two_rank_search`` in
``test_torch_search.py::test_from_postings_builds_the_reference_bytes``.
Each also stands alone as a named test when this file is named on the
command line (``python -m pytest tests/_torch_distributed.py -k two_rank``).
Against the reference package, on the CPU, with inputs made from a seed
with numpy:

* ``grad_comp`` on a normal leaf, a clustered hot-region leaf (bitmap
  containers) and leaves with ties at the threshold (zeros, and equal
  magnitudes of both signs): ``compress_leaf``'s ``serialize()`` bytes and
  values, ``decompress_leaf``, ``compression_ratio``, ``leaf_overlap``,
  ``leaf_jaccard``, ``leaf_overlap_many`` and ``leaf_topk_overlap`` equal
  the reference's exactly; ``compressed_crosspod_mean`` on a one-rank gloo
  mesh equals the reference's ``decompress_leaf(compress_leaf(g))`` and
  raises with no declared mesh; a reduced gemma2-2b ``train_step`` with
  ``grad_compression`` runs and hands the optimizer the compressed
  gradients (clipping comes after); ``spec_for_path`` equals the
  reference's for every leaf of the reduced gemma2-2b and stablelm-1.6b
  trees and their AdamW moments on a ``{"data": 2, "model": 2}`` mesh (the
  rules read only the mesh's sizes);
* two gloo ranks (``torch.multiprocessing.spawn``, a ``file://`` store,
  joined within ``TWO_RANK_S``), for training: ``compressed_crosspod_mean``
  equals the mean of the reference's per-rank
  ``decompress_leaf(compress_leaf(g_r))``; ``reshard_tree`` places every
  leaf of the reduced parameters on its ``params_shardings`` placements and
  round-trips it (``full_tensor()`` equal to the input); ``elastic_remesh``
  builds the ``(2, 1)`` and ``(1, 2, 1)`` meshes, ``launch.mesh.
  make_test_mesh`` the ``(2, 1)`` ("data", "model") mesh, and
  ``make_production_mesh`` refuses a group of 2 ranks;
* two gloo ranks, for search: ``PostingIndex.shard`` of an odd row count
  (one padding row) gives a sharded ``topk`` equal to the reference's
  unsharded ``topk_by_card``.
"""

import contextlib
import dataclasses
import os
import tempfile
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from _torch_parity import release_jax_executables  # noqa: F401
from repro import grad_comp as JGC
from repro import roaring as JRG
from repro import search as JS
from repro.configs import get_config as j_config
from repro.distributed import sharding as JSH
from repro.models import transformer as JT
from repro.optim import adamw as j_adamw
from repro_torch import _tree
from repro_torch import grad_comp as TGC
from repro_torch import roaring as TRG
from repro_torch import search as TS
from repro_torch.configs import get_config as t_config
from repro_torch.distributed import context
from repro_torch.distributed import sharding as TSH
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import transformer as TT
from repro_torch.optim import OptimizerDef
from repro_torch.optim import adamw as t_adamw
from repro_torch.runtime import elastic_remesh, reshard_tree
from repro_torch.train import TrainState, make_train_step

SEED = 1402
RATIO, MIN_K = 0.01, 64
N_DOCS = 150_000          # C = 3 chunks
N_TERMS = 12              # 13 stack rows: odd, so two ranks pad one row
TOPK = 13
TWO_RANK_S = 120


def _leaves():
    """(name, f32 numpy leaf): normal; clustered, whose k top values fill
    one chunk past 4,096 (a bitmap container); ties at the threshold
    (zeros; equal magnitudes of both signs); k = n (every index kept)."""
    rng = np.random.default_rng(SEED)
    normal = rng.standard_normal((300, 700)).astype(np.float32)
    hot = (rng.standard_normal(7 * 65536) * 1e-3).astype(np.float32)
    hot[70_000:80_000] = rng.standard_normal(10_000) + 10.0
    zeros = np.zeros(5000, np.float32)
    zeros[rng.choice(5000, 40, replace=False)] = rng.standard_normal(40)
    levels = rng.integers(-3, 4, 20_000).astype(np.float32) * 0.5
    return [("normal", normal), ("hot", hot), ("zeros", zeros),
            ("levels", levels), ("all", normal[:1, :50].copy())]


def _k(g):
    return max(MIN_K, int(np.ceil(g.size * RATIO)))


def _j_compress(g, k):
    return JGC.compress_leaf(jnp.asarray(g), k)


def _t_compress(g, k):
    return TGC.compress_leaf(torch.from_numpy(g), k)


def check_grad_comp():
    comps = []
    for name, g in _leaves():
        j, t = _j_compress(g, _k(g)), _t_compress(g, _k(g))
        assert t.slab.serialize() == j.slab.serialize(), name
        assert t.slab.C == j.slab.C, name
        assert np.array_equal(t.values.numpy(), np.asarray(j.values)), name
        want = np.asarray(JGC.decompress_leaf(j, g.shape, jnp.float32))
        got = TGC.decompress_leaf(t, g.shape, torch.float32).numpy()
        assert np.array_equal(got, want), name
        assert TGC.compression_ratio(t, g.size) == \
            JGC.compression_ratio(j, g.size), name
        comps.append((name, g, want))
    kinds = {n: set(_t_compress(g, _k(g)).slab.kinds.tolist())
             for n, g, _ in comps}
    assert 2 in kinds["hot"] and 1 in kinds["normal"], kinds
    _check_trees(comps)
    _check_overlaps()
    _check_one_rank_mean(comps)
    _check_train_step()
    _check_specs()


def _check_trees(comps):
    """``compress_tree`` -> ``decompress_tree`` over a nested tree equals
    the reference's, leaf for leaf, and each leaf's own round trip."""
    jt = {"b": [jnp.asarray(g) for _, g, _ in comps[:2]],
          "a": jnp.asarray(comps[2][1])}
    tt = {"b": [torch.from_numpy(g.copy()) for _, g, _ in comps[:2]],
          "a": torch.from_numpy(comps[2][1].copy())}
    want = JGC.decompress_tree(JGC.compress_tree(jt, RATIO, MIN_K), jt)
    got = TGC.decompress_tree(TGC.compress_tree(tt, RATIO, MIN_K), tt)
    for w, t, (_, _, d) in zip(jax.tree.leaves(want), _tree.leaves(got),
                               [comps[2], comps[0], comps[1]]):
        assert np.array_equal(t.numpy(), np.asarray(w))
        assert np.array_equal(t.numpy(), d)


def _check_overlaps():
    """Supports of steps drifting over one leaf shape."""
    rng = np.random.default_rng(SEED + 1)
    base = rng.standard_normal(4 * 65536).astype(np.float32)
    steps = []
    for s in range(5):
        g = base + rng.standard_normal(base.size).astype(np.float32) * s
        g[s * 20_000:s * 20_000 + 6000] += 50.0      # a hot region (bitmap)
        steps.append((_j_compress(g, 8000), _t_compress(g, 8000)))
    (j0, t0), rest = steps[0], steps[1:]
    for j, t in rest:
        assert int(TGC.leaf_overlap(t0, t)) == int(JGC.leaf_overlap(j0, j))
        assert float(TGC.leaf_jaccard(t0, t)) == \
            float(JGC.leaf_jaccard(j0, j))
    jm = np.asarray(JGC.leaf_overlap_many(j0, [j for j, _ in rest]))
    tm = TGC.leaf_overlap_many(t0, [t for _, t in rest])
    assert tm.dtype == torch.int32 and np.array_equal(tm.numpy(), jm)
    ties = [t for _, t in rest] + [t for _, t in rest[:2]]
    js, ji = JGC.leaf_topk_overlap(j0, [j for j, _ in rest]
                                   + [j for j, _ in rest[:2]], 4)
    ts, ti = TGC.leaf_topk_overlap(t0, ties, 4)
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert TGC.leaf_overlap_many(t0, []).shape == (0,)


@contextlib.contextmanager
def _one_rank_pod():
    """A one-rank gloo group and its ("pod",) mesh, declared for the
    block, torn down after it."""
    store = tempfile.mktemp(prefix="gloo-")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        from torch.distributed.device_mesh import DeviceMesh
        mesh = DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("pod",))
        with context.data_axes(("pod",), 1, None, mesh=mesh):
            yield mesh
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)


def _check_one_rank_mean(comps):
    grads = {"a": [torch.from_numpy(g.copy()) for _, g, _ in comps[:3]],
             "b": [torch.from_numpy(g.copy()) for _, g, _ in comps[3:]]}
    with pytest.raises(ValueError, match="unbound axis name"):
        TGC.compressed_crosspod_mean(grads, axis_name="pod")
    with _one_rank_pod():
        out = TGC.compressed_crosspod_mean(grads, axis_name="pod",
                                           ratio=RATIO, min_k=MIN_K)
        with pytest.raises(ValueError, match="unbound axis name"):
            TGC.compressed_crosspod_mean(grads, axis_name="data")
    for got, (name, _, want) in zip(_tree.leaves(out), comps):
        assert np.array_equal(got.numpy(), want), name


def _check_train_step():
    """One reduced gemma2-2b step with and without compression from the
    same parameters: the optimizer receives exactly the compressed mean of
    the plain step's gradients (clipping is off at this norm bound)."""
    cfg = dataclasses.replace(t_config("gemma2-2b", reduced=True),
                              compute_dtype="float32")
    rng = np.random.default_rng(SEED + 2)
    toks = rng.integers(0, cfg.vocab, (2, 33))
    batch = {"tokens": torch.from_numpy(toks),
             "mask": torch.ones(toks.shape, dtype=torch.float32)}
    seen = {}

    def recorder(tag):
        def update(grads, state, params, step):
            seen[tag] = [g.clone() for g in _tree.leaves(grads)]
            return state
        return OptimizerDef(lambda p: None, update)

    params = TT.init_lm(cfg, SEED, device="cpu")
    _, plain = make_train_step(cfg, recorder("plain"), max_grad_norm=1e30)(
        TrainState(params, None, 0), batch)
    comp = {"axis": "pod", "ratio": 0.05}
    with _one_rank_pod():
        _, m = make_train_step(cfg, recorder("comp"), max_grad_norm=1e30,
                               grad_compression=comp)(
            TrainState(params, None, 0), batch)
    assert np.isfinite(float(m["loss"])) and float(m["loss"]) == \
        float(plain["loss"])
    assert float(m["grad_norm"]) < float(plain["grad_norm"])
    for g, c in zip(seen["plain"], seen["comp"]):
        k = max(64, int(np.ceil(g.numel() * 0.05)))
        assert torch.equal(c, TGC.decompress_leaf(
            TGC.compress_leaf(g, k), g.shape, g.dtype))
    # a real AdamW step with compression runs and changes the parameters
    opt = t_adamw(1e-3)
    params = TT.init_lm(cfg, SEED, device="cpu")
    state = TrainState(params, opt.init(params), 0)
    before = [p.clone() for p in _tree.leaves(params)]
    with _one_rank_pod():
        state, m = make_train_step(cfg, opt, grad_compression=comp)(
            state, batch)
    assert np.isfinite(float(m["loss"]))
    assert any(not torch.equal(a, b) for a, b in
               zip(before, _tree.leaves(state["params"])))


def _check_specs():
    sizes = {"data": 2, "model": 2}
    fake = types.SimpleNamespace(shape=sizes)
    for arch in ("gemma2-2b", "stablelm-1.6b"):
        jp = JT.init_lm(jax.random.PRNGKey(0), j_config(arch, reduced=True))
        tp = TT.init_lm(t_config(arch, reduced=True), 0, device="cpu")
        for jtree, ttree in ((jp, tp), (j_adamw(1e-3).init(jp),
                                        t_adamw(1e-3).init(tp))):
            want = [(jax.tree_util.keystr(p), tuple(JSH.spec_for_path(
                p, x, fake))) for p, x in
                jax.tree_util.tree_flatten_with_path(jtree)[0]]
            got = [TSH.spec_for_path(p, x, sizes)
                   for p, x in _tree.leaves_with_paths(ttree)]
            assert len(got) == len(want), arch
            assert got == [s for _, s in want], (arch, want)
            assert any(s for s in got), arch
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                 shape=(2, 2, 2))
    for mode in ("auto", "replicate"):
        assert TSH.batch_spec(mesh, mode) == tuple(JSH.batch_spec(
            types.SimpleNamespace(shape={"pod": 2, "data": 2, "model": 2}),
            mode)), mode
    assert TSH.kv_cache_spec(sizes) == tuple(JSH.kv_cache_spec(fake))
    assert TSH.posting_spec(sizes) == tuple(JSH.posting_spec(fake))
    assert TSH.posting_spec(sizes, "pod") == \
        tuple(JSH.posting_spec(fake, "pod"))


# =============================================================================
# two gloo ranks
# =============================================================================

def _postings():
    rng = np.random.default_rng(SEED + 3)
    return {f"t{i:02d}": np.unique(rng.integers(
        0, N_DOCS, max(4, int(0.4 * N_DOCS * (i + 1) ** -1.2))))
        for i in range(N_TERMS)}


def _train_worker(rank, world, store, want):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import Replicate
        pod = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("pod",))
        grads = {"w": [torch.from_numpy(g[rank].copy())
                       for g in want["grads"]]}
        with context.data_axes(("pod",), world, None, mesh=pod):
            out = TGC.compressed_crosspod_mean(grads, axis_name="pod",
                                               ratio=RATIO, min_k=MIN_K)
        for got, mean in zip(out["w"], want["means"]):
            assert np.array_equal(got.numpy(), mean)

        mesh = elastic_remesh(("data", "model"))
        assert mesh.shape == (2, 1)
        assert mesh.mesh_dim_names == ("data", "model")
        m3 = elastic_remesh(("pod", "data", "model"))
        assert m3.shape == (1, 2, 1)
        assert m3.mesh_dim_names == ("pod", "data", "model")
        with pytest.raises(ValueError):
            elastic_remesh(("data", "model"), model_parallel=3)

        tm = launch_mesh.make_test_mesh(data=2, model=1)
        assert tm.shape == (2, 1) and tm.mesh_dim_names == ("data", "model")
        assert tm.device_type == "cpu"
        with pytest.raises(ValueError):        # 256 ranks, not 2
            launch_mesh.make_production_mesh()

        cfg = t_config("gemma2-2b", reduced=True)
        params = TT.init_lm(cfg, SEED, device="cpu")
        placed = reshard_tree(params, mesh)
        shardings = TSH.params_shardings(params, mesh)
        n_sharded = 0
        for (path, a), b in zip(_tree.leaves_with_paths(params),
                                _tree.leaves(placed)):
            pl = shardings
            for key in path:
                pl = pl[key]
            assert tuple(b.placements) == pl, path
            assert torch.equal(b.full_tensor(), a)
            n_sharded += b.to_local().shape != a.shape
        assert n_sharded > 0
        # the pure data-parallel layout replicates every leaf
        rep = TSH.params_shardings(params, mesh, "replicate")
        assert all(pl == (Replicate(), Replicate()) for pl in
                   _tree.leaf_nodes(params, rep))
    finally:
        dist.destroy_process_group()


def _search_worker(rank, world, store, want):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = elastic_remesh(("data", "model"))
        index = TS.PostingIndex.from_postings(want["postings"], N_DOCS,
                                              device="cpu")
        sharded = index.shard(mesh)
        assert index.n_rows == N_TERMS + 1 and sharded.n_rows == N_TERMS + 2
        assert sharded.stack.payload.to_local().shape[0] == sharded.n_rows // 2
        assert "sharded" in repr(sharded)
        for q, scores, rows in want["topk"]:
            tq = TRG.RoaringSlab.from_values(q, index.C, q.size,
                                             device="cpu")
            s, r = sharded.topk(tq, TOPK)
            assert np.array_equal(s.numpy(), scores)
            assert np.array_equal(r.numpy(), rows)
    finally:
        dist.destroy_process_group()


def _spawn(worker, want):
    """Run ``worker`` on two gloo ranks; fail past ``TWO_RANK_S``."""
    store = tempfile.mktemp(prefix="gloo-")
    ctx = mp.spawn(worker, args=(2, store, want), nprocs=2, join=False)
    deadline = time.monotonic() + TWO_RANK_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail(f"two gloo ranks ran past {TWO_RANK_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        if os.path.exists(store):
            os.remove(store)


def check_two_rank_training():
    rng = np.random.default_rng(SEED + 4)
    grads, means = [], []
    for shape in ((2, 300, 700), (2, 5000)):
        g = rng.standard_normal(shape).astype(np.float32)
        g[1, :100] = 0.0
        acc = np.zeros(shape[1:], np.float32)
        for r in range(2):
            k = max(MIN_K, int(np.ceil(g[r].size * RATIO)))
            acc += np.asarray(JGC.decompress_leaf(
                _j_compress(g[r], k), g[r].shape, jnp.float32))
        grads.append(g)
        means.append(acc / np.float32(2))
    _spawn(_train_worker, {"grads": grads, "means": means})


def check_two_rank_search():
    rng = np.random.default_rng(SEED + 5)
    postings = _postings()
    jindex = JS.PostingIndex.from_postings(postings, N_DOCS)
    assert jindex.n_rows % 2 == 1
    topk = []
    for i in range(4):
        q = np.unique(rng.integers(0, N_DOCS, 3000 * (i + 1)))
        jq = JRG.RoaringSlab.from_values(q, jindex.C, q.size)
        s, r = jindex.topk(jq, TOPK)
        topk.append((q, np.asarray(s), np.asarray(r)))
    _spawn(_search_worker, {"postings": postings, "topk": topk})


# named tests, collected only when this file is named on the command line


def test_grad_comp_matches_reference():
    check_grad_comp()


def test_two_rank_training_layer():
    check_two_rank_training()


def test_two_rank_sharded_search():
    check_two_rank_search()
