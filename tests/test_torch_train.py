"""Port parity: the training path.

Three test items (the tier-1 memory-map budget holds the suite to 383
collected tests; see ROADMAP queue 3). Against the reference package, on
the CPU, with inputs made from a seed with numpy:

* block-sparse attention: the port's plain ``sparse_attention`` against the
  reference's oracle ``sparse_attention_ref`` and its Pallas kernel in
  interpret mode (forward), and against ``jax.vjp`` of the reference's
  ``custom_vjp`` (``dq`` / ``dk`` / ``dv``), on ``cases.sparse_flash_case``.
  Its row 0 lists only a block in its future: the port and the oracle give
  zeros, the Pallas kernel the mean of V (a known reference defect, ROADMAP
  queue 3), which the test asserts as it stands. A NaN in the one unlisted
  block changes no output and no gradient;
* the blocked online-softmax branch (``flash_attn``) against
  ``flash_attn_jnp`` at S = 2048, global and sliding-window, forward and
  gradients;
* ``compile_mask`` / ``build_arch_mask`` and the other mask builders, the
  device mask algebra on CPU slabs (``union_many(device="cpu")``,
  ``rows_to_slabs``, ``mask_overlap_cards``, ``mask_jaccard``), and
  ``DataPipeline`` batches, exactly;
* reduced gemma2-2b with ``attn_impl="sparse"`` at S = 2048 (global layers
  through the block-sparse path, local ones through the blocked branch),
  ``remat="full"``, f32 compute: three ``make_train_step`` steps with AdamW
  from one state (taken after one reference step and carried over with
  ``models.convert.state_from_numpy``), comparing loss, grad norm and every
  parameter and moment after each step;
* ``launch.train.main`` under ``ResilientTrainer`` with one simulated
  failure ends on the parameters of an uninterrupted run, exactly, and its
  checkpoints read back through the reference's ``restore_checkpoint``;
* inside the masks-and-data item: ``forward`` / ``lm_loss`` / ``encode``
  and MoE routing of every reduced config of the registry
  (``_torch_archs.check_forward_and_encode``);
* inside the train-steps item: Roaring top-k gradient compression, the
  compressed train step and the sharding rules
  (``_torch_distributed.check_grad_comp``), ``models/flops.py``
  (``_torch_baselines.check_flops``), and training every architecture of
  the registry: Adafactor and 8-bit AdamW, two train steps of each reduced
  config with ``pick_optimizer``'s optimizer (qwen2-vl's patches,
  whisper's memory), ``remat="dots"`` and ``launch.specs``
  (``_torch_train_archs.check_optimizers_and_train_steps``);
* inside the resilient-training item: the compressed cross-pod mean,
  ``elastic_remesh``, ``reshard_tree`` and ``launch.mesh`` over two gloo
  ranks (``_torch_distributed.check_two_rank_training``), and the training
  launcher for whisper-base and jamba
  (``_torch_train_archs.check_launcher_archs``).

Tolerances (float32 throughout, sums taken in another order): attention
outputs and gradients ``ATOL`` / ``RTOL``; loss and grad norm ``RTOL``;
parameters and moments after AdamW steps ``P_ATOL`` / ``RTOL``: AdamW
divides m by sqrt(v), so an f32 difference in a gradient entry moves its
parameter by at most about lr x that relative difference.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_archs import check_forward_and_encode
from _torch_baselines import check_flops
from _torch_distributed import check_grad_comp, check_two_rank_training
from _torch_train_archs import (check_launcher_archs,
                                check_optimizers_and_train_steps)
from _torch_parity import release_jax_executables  # noqa: F401
from _torch_threads import share_cores_between_workers
from repro import sparsity as RS
from repro.configs import get_config as ref_config
from repro.data import BitmapIndex as RIndex
from repro.data import DataPipeline as RPipe
from repro.data import PipelineState as RPState
from repro.data import SyntheticCorpus as RCorpus
from repro.kernels.sparse_attn import kernel as RK
from repro.kernels.sparse_attn import ops as RO
from repro.kernels.sparse_attn import ref as RR
from repro.models import attention as RA
from repro.models import transformer as RT
from repro.optim import adamw as r_adamw
from repro.optim import cosine_schedule as r_cosine
from repro.checkpoint import restore_checkpoint as r_restore
from repro.train import TrainState as RState
from repro.train import make_train_step as r_make_step
from repro_torch import _tree
from repro_torch import sparsity as PS
from repro_torch.configs import get_config as port_config
from repro_torch.data import BitmapIndex as PIndex
from repro_torch.data import DataPipeline as PPipe
from repro_torch.data import PipelineState as PPState
from repro_torch.data import SyntheticCorpus as PCorpus
from repro_torch.kernels.sparse_attn import cases
from repro_torch.kernels.sparse_attn import ops as PO
from repro_torch.launch import train as LT
from repro_torch.models import attention as PA
from repro_torch.models.convert import state_from_numpy
from repro_torch.optim import adamw as p_adamw
from repro_torch.optim import cosine_schedule as p_cosine
from repro_torch.runtime import simulate_failure
from repro_torch.train import make_train_step as p_make_step

share_cores_between_workers()

SEED = 1402
ATOL, RTOL = 2e-5, 2e-4
LR = 1e-3
P_ATOL = 2e-6


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, want, what, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


def _configs(**kw):
    """(reference cfg, port cfg): reduced gemma2-2b, float32 compute."""
    return tuple(dataclasses.replace(get("gemma2-2b", reduced=True),
                                     compute_dtype="float32", **kw)
                 for get in (ref_config, port_config))


def test_attention_masks_and_data_match_reference():
    rng = np.random.default_rng(SEED)
    for G, D, softcap, causal in ((2, 16, 50.0, True), (1, 32, None, False)):
        _check_sparse_attention(rng, G, D, softcap, causal)
    rcfg, pcfg = _configs()
    for window in (None, rcfg.window):
        _check_flash(rng, rcfg, pcfg, window)
    _check_masks()
    _check_data()
    check_forward_and_encode()


def _check_sparse_attention(rng, G, D, softcap, causal):
    seed = int(rng.integers(1 << 30))
    c = cases.sparse_flash_case(np.random.default_rng(seed), G, D,
                                nan=False)
    names = ("q", "k", "v", "kv_idx", "counts")
    opts = dict(causal=causal, softcap=softcap)
    j = [jnp.asarray(c[n]) for n in names]
    want = np.asarray(RR.sparse_attention_ref(*j, **opts))
    pallas = np.asarray(RK.sparse_flash_attention(*j, interpret=True, **opts))
    g = rng.standard_normal(want.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: RO.sparse_attention(
        q, k, v, j[3], j[4], 128, 128, causal, softcap, None, False), *j[:3])
    want_grads = vjp(jnp.asarray(g))

    t = {n: torch.from_numpy(c[n]) for n in names}
    qkv = [t[n].clone().requires_grad_(True) for n in "qkv"]
    got = PO.sparse_attention(*qkv, t["kv_idx"], t["counts"], 128, 128,
                              causal, softcap, None)
    got.backward(torch.from_numpy(g))
    what = f"sparse_attention G={G} D={D} softcap={softcap} causal={causal}"
    _close(_np(got), want, what)
    for x, w, n in zip(qkv, want_grads, "qkv"):
        _close(_np(x.grad), np.asarray(w), f"{what}: d{n}")

    # row 0 lists only block 2: under the causal mask no score is live
    row0 = slice(0, cases.FLASH_BLOCK)
    rest = slice(cases.FLASH_BLOCK, None)
    _close(_np(got)[:, :, rest], pallas[:, :, rest], what + " vs Pallas")
    if causal:
        assert not _np(got)[:, :, row0].any()
        blk2 = slice(2 * cases.FLASH_BLOCK, 3 * cases.FLASH_BLOCK)
        v_mean = c["v"][:, :, blk2].mean(axis=2, keepdims=True)
        _close(pallas[:, :, row0], np.repeat(np.repeat(
            v_mean, G, axis=1), cases.FLASH_BLOCK, axis=2),
            "the Pallas kernel's all-masked row is the mean of V")
    else:
        _close(_np(got)[:, :, row0], pallas[:, :, row0], what + " vs Pallas")

    # NaN in the unlisted block changes no output and no gradient
    cn = cases.sparse_flash_case(np.random.default_rng(seed), G, D)
    tn = {n: torch.from_numpy(cn[n]) for n in names}
    qkv_n = [tn[n].clone().requires_grad_(True) for n in "qkv"]
    out_n = PO.sparse_attention(*qkv_n, tn["kv_idx"], tn["counts"], 128, 128,
                                causal, softcap, None)
    out_n.backward(torch.from_numpy(g))
    assert torch.equal(out_n, got), what + ": NaN block leaked"
    for a, b in zip(qkv_n, qkv):
        assert torch.equal(a.grad, b.grad), what + ": NaN block leaked"


def _check_flash(rng, rcfg, pcfg, window):
    B, S, H, KVH, hd = 1, 2048, rcfg.n_heads, rcfg.n_kv_heads, rcfg.hd
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, hd)).astype(np.float32)
    g = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    want, vjp = jax.vjp(lambda q, k, v: RA.flash_attn_jnp(
        q, k, v, rcfg, causal=True, window=window), *map(jnp.asarray,
                                                         (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    qkv = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    got = PA.flash_attn(*qkv, pcfg, causal=True, window=window)
    got.backward(torch.from_numpy(g))
    what = f"flash_attn S={S} window={window}"
    _close(_np(got), np.asarray(want), what)
    for x, w, n in zip(qkv, want_grads, "qkv"):
        _close(_np(x.grad), np.asarray(w), f"{what}: d{n}")


def _rows(builder):
    return [r.to_array().tolist() for r in builder.rows]


def _check_masks():
    for n, kw in ((32, dict(pattern="local_global", window_blocks=8,
                            n_global=4)),
                  (16, dict(pattern="local", window_blocks=3)),
                  (12, dict(pattern="local_global", window_blocks=2,
                            n_global=3, causal=False))):
        rb, pb = (m.build_arch_mask(n, **kw) for m in (RS, PS))
        assert _rows(pb) == _rows(rb)
        for got, want in zip(PS.compile_mask(pb), RS.compile_mask(rb)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
        assert pb.density() == rb.density()
        assert pb.size_in_bytes() == rb.size_in_bytes()
    # the full-width training mask: 318 of 1,024 blocks live
    kv_idx, counts = PS.compile_mask(PS.build_arch_mask(
        32, pattern="local_global", window_blocks=8, n_global=4))
    assert int(counts.sum()) == 318 and kv_idx.shape == (32, 12)
    for fn, args in (("causal_mask", (9,)),
                     ("local_window_mask", (9, 3, False)),
                     ("global_stripe_mask", (9, [0, 4])),
                     ("doc_boundary_mask", (9, [3, 7]))):
        rb = RS.MaskBuilder(getattr(RS, fn)(*args))
        pb = PS.MaskBuilder(getattr(PS, fn)(*args))
        assert _rows(pb) == _rows(rb), fn
    ra = RS.MaskBuilder(RS.causal_mask(9))
    rw = RS.MaskBuilder(RS.local_window_mask(9, 2))
    rd = RS.MaskBuilder(RS.doc_boundary_mask(9, [4]))
    pa = PS.MaskBuilder(PS.causal_mask(9))
    pw = PS.MaskBuilder(PS.local_window_mask(9, 2))
    pd = PS.MaskBuilder(PS.doc_boundary_mask(9, [4]))
    assert _rows(pa.union_many([pw, pd], device=False)) == _rows(
        ra.union_many([rw, rd], device=False))
    # the device algebra: the slab engine on CPU slabs against the
    # reference's slab engine
    assert _rows(pa.union_many([pw, pd], device="cpu")) == _rows(
        ra.union_many([rw, rd], device=True))
    ps, rs = PS.rows_to_slabs(pa.rows, device="cpu"), RS.rows_to_slabs(ra.rows)
    for leaf in ("keys", "kinds", "cards", "nruns"):
        assert np.array_equal(getattr(ps, leaf).numpy(),
                              np.asarray(getattr(rs, leaf)))
    assert np.array_equal(ps.payload.numpy().view(np.uint16),
                          np.asarray(rs.payload))
    for fn in ("mask_overlap_cards", "mask_jaccard"):
        got = getattr(PS, fn)(pa, pw, device="cpu")
        want = np.asarray(getattr(RS, fn)(ra, rw))
        assert got.dtype == want.dtype and np.array_equal(got, want), fn
    assert _rows(pa.intersect(pd).subtract(pw)) == _rows(
        ra.intersect(rd).subtract(rw))
    assert PS.mask_density(*PS.compile_mask(pa)) == RS.mask_density(
        *RS.compile_mask(ra))


def _check_data():
    query = "quality>=1&!dedup_dup|lang=3"
    rc, pc = RCorpus(3000, 512, seed=7, mean_len=80), PCorpus(
        3000, 512, seed=7, mean_len=80)
    ri, pi = RIndex(rc), PIndex(pc)
    assert np.array_equal(pi.query(query).to_array(),
                          ri.query(query).to_array())
    rp = RPipe(ri, RPState(query=query, seed=3), batch=3, seq_len=200,
               n_shards=2, shard_id=1)
    pp = PPipe(pi, PPState(query=query, seed=3), batch=3, seq_len=200,
               n_shards=2, shard_id=1)
    for _ in range(4):
        (rt, rm, rs), (pt, pm, ps) = rp.next_batch(), pp.next_batch()
        assert np.array_equal(pt, rt) and np.array_equal(pm, rm)
        assert ps.to_array().tolist() == rs.to_array().tolist()
    assert pp.state.to_dict() == rp.state.to_dict()


def _batch(rng, cfg, B, S):
    toks = rng.integers(1, cfg.vocab, (B, S + 1)).astype(np.int32)
    mask = (rng.random((B, S + 1)) < 0.9).astype(np.float32)
    return {"tokens": toks, "mask": mask}


def test_train_steps_match_reference():
    """Three AdamW steps of reduced gemma2-2b with Roaring block-sparse
    global layers at S = 2048, from a state one reference step in. Then
    the train step's other parts against the reference: Roaring top-k
    gradient compression (``grad_comp``, the one-rank cross-pod mean, a
    ``grad_compression`` step), the sharding rules (``spec_for_path``) and
    the analytic FLOP model (``models/flops.py``)."""
    rcfg, pcfg = _configs(attn_impl="sparse")
    S, B = 2048, 1
    lists = RS.compile_mask(RS.build_arch_mask(
        S // rcfg.sparse_block, pattern="local_global", window_blocks=4,
        n_global=2))
    rng = np.random.default_rng(SEED)
    batches = [_batch(rng, rcfg, B, S) for _ in range(4)]
    ropt = r_adamw(r_cosine(LR, warmup=2, total=8))
    rstep = jax.jit(r_make_step(rcfg, ropt, remat="full",
                                block_lists=tuple(map(jnp.asarray, lists))))
    rparams = RT.init_lm(jax.random.PRNGKey(SEED), rcfg)
    rstate = RState(rparams, ropt.init(rparams), 0)
    rstate, _ = rstep(rstate, jax.tree.map(jnp.asarray, batches[0]))

    pstate = state_from_numpy(jax.tree.map(np.asarray, rstate), pcfg,
                              device="cpu")
    pstep = p_make_step(pcfg, p_adamw(p_cosine(LR, warmup=2, total=8)),
                        remat="full", block_lists=lists)
    for i, batch in enumerate(batches[1:]):
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, batch))
        pstate, pm = pstep(pstate, batch)
        what = f"step {i + 1}"
        _close(float(pm["loss"]), float(rm["loss"]), what + " loss",
               atol=0)
        _close(float(pm["grad_norm"]), float(rm["grad_norm"]),
               what + " grad norm", atol=0)
        assert int(pstate["step"]) == int(rstate["step"])
        for got, want in zip(_tree.leaves(pstate["params"]) +
                             _tree.leaves(pstate["opt"]),
                             jax.tree.leaves(rstate["params"]) +
                             jax.tree.leaves(rstate["opt"])):
            _close(_np(got), np.asarray(want), what + " state",
                   atol=P_ATOL)
    check_grad_comp()
    check_flops()
    check_optimizers_and_train_steps()


def test_resilient_training_matches_uninterrupted(tmp_path):
    """``launch.train.main`` with one simulated failure: one restart, and
    the final parameters equal an uninterrupted run's, bit for bit; the
    reference reads the port's checkpoints leaf for leaf. Then the
    distributed layer that recovery and the cross-pod mean run on, over
    two gloo ranks: the compressed cross-pod mean, ``elastic_remesh``,
    ``reshard_tree`` and ``launch.mesh``; and the launcher for two more
    architectures (whisper-base, jamba)."""
    argv = ["--arch", "gemma2-2b", "--reduced", "--steps", "6", "--batch",
            "2", "--seq", "64", "--ckpt-every", "2", "--log-every", "100",
            "--device", "cpu"]
    whole = LT.main(argv + ["--ckpt", str(tmp_path / "whole")])
    failed = LT.main(argv + ["--ckpt", str(tmp_path / "failed")],
                     failure_source=simulate_failure({3}))
    assert whole["restarts"] == 0 and failed["restarts"] == 1
    assert len(failed["losses"]) == 7            # step 2 ran twice
    for a, b in zip(_tree.leaves(failed["state"]),
                    _tree.leaves(whole["state"])):
        assert torch.equal(a, b)

    ckpt = str(tmp_path / "whole")
    assert sorted(os.listdir(ckpt)) == ["step_00000002", "step_00000004",
                                        "step_00000006"]
    rcfg = ref_config("gemma2-2b", reduced=True)
    rparams = RT.init_lm(jax.random.PRNGKey(0), rcfg)
    like = RState(rparams, r_adamw(1e-3).init(rparams), 0)
    tree, extra, step = r_restore(ckpt, like)
    assert step == 6 and extra == {"data_step": 6}
    for got, want in zip(jax.tree.leaves(tree),
                         _tree.leaves(whole["state"])):
        assert np.array_equal(np.asarray(got), _np(want))
    check_two_rank_training()
    check_launcher_archs(tmp_path)
