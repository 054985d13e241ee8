"""Port parity: training every architecture of the model registry.

The checks run inside existing test items (the tier-1 memory-map budget
holds the suite to 383 collected tests; see ROADMAP queue 3d):
``check_optimizers_and_train_steps`` in ``test_torch_train.py::
test_train_steps_match_reference`` and ``check_launcher_archs`` in its
``test_resilient_training_matches_uninterrupted``. Named on the command
line, this file runs the same checks as two tests:

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/_torch_train_archs.py

Against the JAX package on the CPU, inputs made from a seed with numpy:

* ``adafactor`` and ``adamw8bit`` over a tree of factored and unfactored
  leaves (f32 and bf16), three steps, each started from the reference's
  state: Adafactor's parameters and state to f32 rounding; 8-bit AdamW's
  codes equal except where the reference's unrounded code lies within
  ``HALF_TOL`` of a half (one f32 rounding of the power may round it the
  other way; no other code may differ), its block scales and parameters to
  f32 rounding;
* two ``make_train_step`` steps of each of the ten reduced configs (f32
  compute; Roaring block-sparse global layers wherever the config has
  attention) with ``launch.specs.pick_optimizer``'s optimizer for the full
  config, from a state at step 2,000 (the schedule's peak learning rate;
  the optimizer state starts at zero): loss, grad norm and every parameter
  and state leaf after each step. qwen2-vl takes 8 stub patch embeddings
  (``extra_embeds``), whisper runs with ``memory`` and without it (its
  encoder, and then its cross-attention, unused: zero gradients, updated
  by weight decay as the reference does), and the MoE configs route no
  token to their last expert (its router column ties with a lower
  expert's, and ties go to the lower index). The reference's step is
  jitted once per config;
* ``remat="dots"`` and ``remat="full"`` against ``"none"`` on the port,
  on three configs (dense, MoE, Mamba hybrid);
* ``launch.specs``: ``input_specs`` of every architecture and shape,
  ``pick_optimizer`` of every architecture, and ``build_cell`` against the
  reference's on an ``AbstractMesh`` for all 40 cells on the single-pod
  (16, 16) mesh and the 10 train_4k cells on the multi-pod (2, 16, 16)
  one (the port's arguments on ``meta``, at full width): every argument
  leaf's path, shape and dtype, every spec against the reference's
  ``PartitionSpec``, ``donate_argnums`` and ``meta``, and the bytes a rank
  holds against the sum of ``NamedSharding.shard_shape`` x itemsize,
  exactly; each of ``specs.py``'s four ``REPRO_*`` knobs on one cell, set
  and then restored;
* one train step of a reduced config under ``REPRO_ACCUM_DTYPE=bf16`` and
  one under ``REPRO_GRAD_AR_DTYPE=bf16`` (microbatch 1, batch 2), each
  against the reference's step under the same variable (``REPRO_MOE_GATHER``
  acts only on DTensor weights, which no path of the port has, so it has
  no check);
* ``launch.collectives`` on two cells worked out by hand, and against the
  reference's compiled HLO (``hlo_analysis.collective_bytes``) on a 2 x 2
  host mesh in a subprocess, for three reduced gemma2-2b cells: the FSDP
  gathers exactly, the other terms in the direction of their stated gaps
  (``_check_collectives_hlo``);
* ``launch.train.main`` for whisper-base and jamba (reduced, CPU): the
  loss is finite and the reference's ``restore_checkpoint`` reads the
  port's checkpoint into its own train state's structure; and the dry
  run's ``run_cell`` on two cells into a temporary directory.

Tolerances: f32 sums taken in another order: loss and grad norm ``RTOL``,
parameters and state ``P_ATOL`` / ``RTOL`` (as ``test_torch_train.py``);
an AdamW parameter entry at its leaf's gradient noise floor is held to the
update its own moments give, and its first moment to the reference's sign
(``_check_state``). Under the two bf16 gradient knobs both packages round
the gradient to bf16, where an f32 sum taken in another order can round
the other way, one bf16 step (up to 2^-7 of the entry) apart: the
optimizer state is held to ``BF16_RTOL`` (2^-6: the second moment squares
the entry), the loss, grad norm and parameters to the tolerances above.
"""

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import AbstractMesh

from repro import sparsity as RS
from repro.checkpoint import restore_checkpoint as r_restore
from repro.configs import SHAPES as R_SHAPES
from repro.configs import get_config as ref_config
from repro.launch import specs as RSP
from repro.models import transformer as RT
from repro.optim import adafactor as r_adafactor
from repro.optim import adamw as r_adamw
from repro.optim import adamw8bit as r_adamw8bit
from repro.optim import optimizers as ROPT
from repro.train import TrainState as RState
from repro.train import make_train_step as r_make_step
from repro_torch import _tree
from repro_torch.configs import SHAPES as P_SHAPES
from repro_torch.configs import get_config as port_config
from repro_torch.configs import list_archs
from repro_torch.kernels.sparse_attn.kernel import FLASH_HEAD_DIMS
from repro_torch.launch import collectives as PC
from repro_torch.launch import dryrun as PDR
from repro_torch.launch import specs as PSP
from repro_torch.launch import train as LT
from repro_torch.models import mlp as PM
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_numpy, state_from_numpy
from repro_torch.optim import adafactor as p_adafactor
from repro_torch.optim import adafactor_factored
from repro_torch.optim import adamw as p_adamw
from repro_torch.optim import adamw8bit as p_adamw8bit
from repro_torch.optim import cosine_schedule as p_cosine
from repro_torch.train import make_train_step as p_make_step
from repro_torch.train import trainer as PTR

SEED = 2000
RTOL = 2e-4
P_ATOL = 2e-6
HALF_TOL = 1e-3
LR = 1e-3
B = 2
S = 256                     # two blocks of 128 for the block-sparse layers
VIS_PATCHES, ENC_FRAMES = 8, 12
START_STEP = 2000           # pick_optimizer's schedule peaks here
NOISE_FLOOR = 1e-4
SIGN_FLOOR = 1e-6
ADAMW = (np.float32(0.9), np.float32(0.95), np.float32(1e-8), np.float32(0.1))
# adjacent bf16 roundings of a gradient entry differ by up to 2^-7 of it;
# the second moment squares the entry
BF16_RTOL = 2.0 ** -6
KNOB_S = 64
REMAT_ARCHS = ("starcoder2-15b", "dbrx-132b", "jamba-1.5-large-398b")


def _np(t):
    return t.detach().cpu().float().numpy()


def _close(got, want, what, atol=P_ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


def _to_np(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32))
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


# ---------------------------------------------------------------- optimizers

def _opt_tree(rng):
    """Factored ([3, 64, 128], [128, 40] and a bf16 [64, 64]) and
    unfactored ([3, 100], [10], [4, 8, 16]) leaves in nested dicts and a
    list, as the parameter trees are."""
    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.1
    return {"a": f(3, 64, 128), "b": [f(3, 100), {"c": f(128, 40)}],
            "d": f(10), "e": f(4, 8, 16),
            "h": jnp.asarray(f(64, 64), jnp.bfloat16)}


def _port_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(np.asarray(
        a, np.float32))).to(torch.bfloat16 if a.dtype == jnp.bfloat16
                            else torch.float32), tree)


def _ref_apply(params, updates):
    return jax.tree.map(lambda p, u: (p.astype(jnp.float32)
                                      - u.astype(jnp.float32)).astype(p.dtype),
                        params, updates)


def _check_optimizer(name, ropt, popt, rng):
    rparams = jax.tree.map(jnp.asarray, _opt_tree(rng))
    rstate = ropt.init(rparams)
    rupdate = jax.jit(ropt.update)
    pstate0 = popt.init(_port_tree(rparams))
    assert [tuple(x.shape) for x in _tree.leaves(pstate0)] == [
        x.shape for x in jax.tree.leaves(rstate)], name
    for step in range(3):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(
            p.shape).astype(np.float32)), rparams)
        # the port starts every step from the reference's state
        pparams = _port_tree(rparams)
        pstate = jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                              _to_np(rstate))
        pstate = _tree.unflatten(pstate0, _tree.leaves(pstate))
        pgrads = _port_tree(grads)
        popt.update(pgrads, pstate, pparams, step)
        updates, new_rstate = rupdate(grads, rstate, rparams, step)
        new_rparams = _ref_apply(rparams, updates)
        what = f"{name} step {step}"
        for got, want in zip(_tree.leaves(pparams),
                             jax.tree.leaves(new_rparams)):
            _close(_np(got), np.asarray(want, np.float32), what + " param",
                   atol=1e-7, rtol=1e-5)
        if name == "adamw8bit":
            _check_codes(what, rstate, grads, pstate, new_rstate)
        else:
            for got, want in zip(_tree.leaves(pstate),
                                 jax.tree.leaves(new_rstate)):
                _close(_np(got), np.asarray(want), what + " state",
                       atol=0, rtol=1e-5)
        rparams, rstate = new_rparams, new_rstate


def _per_leaf(x):
    return isinstance(x, dict) and "mq" in x


@jax.jit
def _ref_moments(rstate, grads):
    """The reference's updated m and v of every leaf (its ``update``'s
    formulas), before they are quantized."""
    b1, b2 = 0.9, 0.95
    out = []
    for s, g in zip(jax.tree.leaves(rstate, is_leaf=_per_leaf),
                    jax.tree.leaves(grads)):
        n = s["mq"].shape[0]
        gf = jnp.pad(g.astype(jnp.float32).reshape(-1), (0, n - g.size))
        m = b1 * ROPT._dequantize(s["mq"], s["ms"], 2.0) + (1 - b1) * gf
        v = b2 * ROPT._dequantize(s["vq"], s["vs"], 4.0) + (1 - b2) * gf * gf
        out.append((m, v))
    return out


def _check_codes(what, rstate, grads, pstate, new_rstate):
    """8-bit AdamW: the int8 codes equal the reference's except next to a
    half, where the reference's own unrounded code (its formula, evaluated
    here from its state) lies within ``HALF_TOL`` of x.5."""
    new = jax.tree.leaves(new_rstate, is_leaf=_per_leaf)
    got = _tree.leaves(pstate)
    for i, ((m, v), ns) in enumerate(zip(_ref_moments(rstate, grads), new)):
        pq = dict(zip(("mq", "ms", "vq", "vs"), got[4 * i:4 * i + 4]))
        for kq, ks, x, power in (("mq", "ms", m, 2.0), ("vq", "vs", v, 4.0)):
            xb = np.asarray(x).reshape(-1, ROPT._QBLOCK)
            scale = np.maximum(np.abs(xb).max(-1, keepdims=True), 1e-12)
            code = (127.0 * (np.abs(xb) / scale) ** (1.0 / power)).reshape(-1)
            want_q = np.asarray(ns[kq])
            diff = pq[kq].numpy() != want_q
            near = np.abs(code - np.floor(code) - 0.5) < HALF_TOL
            assert not (diff & ~near).any(), f"{what} leaf {i} {kq}"
            assert (np.abs(pq[kq].numpy().astype(np.int32)
                           - want_q.astype(np.int32)) <= 1).all()
            _close(pq[ks].numpy(), np.asarray(ns[ks]), f"{what} {ks}",
                   atol=0, rtol=1e-5)


def check_optimizers():
    rng = np.random.default_rng(SEED)
    tree = _opt_tree(rng)
    factored = [adafactor_factored(np.shape(x))
                for x in jax.tree.leaves(tree)]
    assert factored == [True, False, True, False, False, True]
    for name, ropt, popt in (
            ("adafactor", r_adafactor(ROPT.cosine_schedule(LR, 1, 10)),
             p_adafactor(p_cosine(LR, 1, 10))),
            ("adamw8bit", r_adamw8bit(ROPT.cosine_schedule(LR, 1, 10)),
             p_adamw8bit(p_cosine(LR, 1, 10)))):
        _check_optimizer(name, ropt, popt, rng)


# ---------------------------------------------------------------- train steps

def _configs(arch):
    """(reference cfg, port cfg), reduced, f32 compute, block-sparse global
    layers where the config has attention."""
    rcfg = ref_config(arch, reduced=True)
    has_attn = any(k.startswith("attn") for k in rcfg.block_kinds())
    kw = dict(compute_dtype="float32")
    if has_attn and rcfg.hd in FLASH_HEAD_DIMS:
        kw["attn_impl"] = "sparse"
    return tuple(dataclasses.replace(get(arch, reduced=True), **kw)
                 for get in (ref_config, port_config))


def _params(arch, i, pcfg):
    """The port's init draw as numpy, with the MoE router's last column
    tied to the one before it (no token routes to the last expert)."""
    tree = jax.tree.map(lambda t: t.numpy(),
                        PT.init_lm(pcfg, SEED + i, device="cpu"))
    for j, kind in enumerate(pcfg.block_kinds()):
        if kind.endswith("_moe"):
            r = tree["blocks"][j]["moe"]["router"]
            r[..., -1] = r[..., -2]
            if pcfg.top_k > 1:      # K = 2 of 4: three tied columns
                r[..., -3] = r[..., -2]
    return tree


def _batches(rng, cfg, n_extra, memory):
    S_tok = S - n_extra
    out = []
    for _ in range(2):
        b = {"tokens": rng.integers(1, cfg.vocab, (B, S_tok + 1)).astype(
            np.int32),
             "mask": (rng.random((B, S_tok + 1)) < 0.9).astype(np.float32)}
        if n_extra:
            b["extra_embeds"] = rng.standard_normal(
                (B, n_extra, cfg.d_model)).astype(np.float32)
        if memory:
            b["memory"] = rng.standard_normal(
                (B, ENC_FRAMES, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _route_spy(into):
    orig = PM.route

    def spy(*args, **kw):
        out = orig(*args, **kw)
        into.append(out[2])
        return out
    return orig, spy


def _run_arch(i, arch, memory, rng):
    rcfg, pcfg = _configs(arch)
    lists = None
    if pcfg.attn_impl == "sparse":
        lists = RS.compile_mask(RS.build_arch_mask(
            S // rcfg.sparse_block, pattern="local_global", window_blocks=1,
            n_global=1))
    n_extra = VIS_PATCHES if rcfg.frontend == "vision" else 0
    batches = _batches(rng, rcfg, n_extra, memory)
    tree = _params(arch, i, pcfg)
    ropt = RSP.pick_optimizer(ref_config(arch))
    popt = PSP.pick_optimizer(port_config(arch))
    assert popt.name == ropt.name, arch
    rparams = jax.tree.map(jnp.asarray, tree)
    rstate = RState(rparams, ropt.init(rparams), START_STEP)
    pstate = state_from_numpy(_to_np(rstate), pcfg, device="cpu")
    rstep = jax.jit(r_make_step(
        rcfg, ropt, block_lists=None if lists is None
        else tuple(map(jnp.asarray, lists))))
    pstep = p_make_step(pcfg, popt, block_lists=lists)
    routed = []
    orig, spy = _route_spy(routed)
    PM.route = spy
    try:
        for s, batch in enumerate(batches):
            prev = [_np(x).copy() for x in _tree.leaves(pstate["params"])]
            rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, batch))
            pstate, pm = pstep(pstate, batch)
            what = f"{arch} (memory={memory}) step {s}"
            _close(float(pm["loss"]), float(rm["loss"]), what + " loss",
                   atol=0)
            _close(float(pm["grad_norm"]), float(rm["grad_norm"]),
                   what + " grad norm", atol=0)
            _check_state(what, pstate, rstate, prev, s)
            if s == 0 and pcfg.n_experts:
                # the first step routed no token to the last expert
                idx = torch.cat([r.reshape(-1) for r in routed])
                assert idx.numel() and not (idx == pcfg.n_experts - 1).any()
    finally:
        PM.route = orig
    if arch in REMAT_ARCHS:
        _check_remat(pcfg, tree, lists, batches[0])


def _check_remat(pcfg, tree, lists, batch):
    """One step of the port under each remat from the same state: "full"
    and "dots" recompute what "none" keeps, so every result agrees (to f32
    rounding: a recomputed product may be summed in another order)."""
    out = {}
    for remat in ("none", "full", "dots"):
        opt = p_adamw(p_cosine(LR, 1, 10))
        params = params_from_numpy(tree, pcfg, device="cpu")
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.tensor(3, dtype=torch.int32)}
        step = p_make_step(pcfg, opt, remat=remat, block_lists=lists)
        state, m = step(state, batch)
        out[remat] = (float(m["loss"]), float(m["grad_norm"]),
                      [_np(x) for x in _tree.leaves(state)])
    for remat in ("full", "dots"):
        what = f"{pcfg.name} remat={remat}"
        _close(out[remat][:2], out["none"][:2], what, atol=0)
        for a, b in zip(out[remat][2], out["none"][2]):
            _close(a, b, what)


def _check_state(what, pstate, rstate, prev, step, state_rtol=RTOL):
    """Every parameter and optimizer-state leaf within ``P_ATOL`` /
    ``RTOL`` after the step from ``START_STEP + step``; ``prev`` holds the
    port's parameters before it. AdamW divides each entry's first moment by
    its own RMS, so an entry whose gradient sits at the noise floor of its
    leaf's f32 sums (RMS below ``NOISE_FLOOR`` of the leaf's, as for a word
    absent from the batch, which only the unembedding's softmax reaches)
    takes an ill-conditioned step of up to ``lr``. Such a parameter entry
    is held instead to the update its own moments give (the weight-decay
    part plus ``lr`` times the normalized step ``mhat / (sqrt(vhat) +
    eps)``, to ``P_ATOL`` / ``RTOL``), and its first moment to the sign of
    the reference's wherever that one lies above ``SIGN_FLOOR`` of its
    leaf's RMS; its moments to ``P_ATOL`` as every entry's."""
    opt = rstate["opt"]
    adamw = set(opt) == {"m", "v"}
    n = len(jax.tree.leaves(rstate["params"]))
    moments = (list(zip(jax.tree.leaves(opt["m"]), jax.tree.leaves(opt["v"]),
                         _tree.leaves(pstate["opt"]["m"]),
                         _tree.leaves(pstate["opt"]["v"])))
                if adamw else [None] * n)
    lr = float(ROPT.cosine_schedule(3e-4, warmup=2000, total=100_000)(
        START_STEP + step))
    t = np.float32(START_STEP + step + 1)
    b1, b2, eps, wd = ADAMW
    for got, want, p0, mv in zip(_tree.leaves(pstate["params"]),
                                 jax.tree.leaves(rstate["params"]), prev,
                                 moments):
        got, want = _np(got), np.asarray(want, np.float32)
        tol = P_ATOL + RTOL * np.abs(want)
        bad = np.abs(got - want) > tol
        if mv is not None:
            rm, rv, pm, pv = (_np(x) if isinstance(x, torch.Tensor)
                              else np.asarray(x) for x in mv)
            quiet = np.sqrt(rv) < NOISE_FLOOR * np.sqrt(np.mean(rv))
            u = (pm / (1 - b1 ** t)) / (np.sqrt(pv / (1 - b2 ** t)) + eps)
            own = p0 - lr * (u + wd * p0)
            bad = np.where(quiet, np.abs(got - own) > tol, bad)
            clear = quiet & (np.abs(rm) > SIGN_FLOOR
                             * np.sqrt(np.mean(rm * rm)))
            flips = clear & (np.sign(pm) != np.sign(rm))
            assert not flips.any(), (f"{what} quiet first moments: "
                                     f"{int(flips.sum())} signs differ")
        assert not bad.any(), (f"{what} param: {int(bad.sum())} entries, "
                               f"max abs err {np.abs(got - want).max()}")
    for got, want in zip(_tree.leaves(pstate["opt"]), jax.tree.leaves(opt)):
        _close(_np(got), np.asarray(want, np.float32), what + " state",
               rtol=state_rtol)


def check_train_steps():
    rng = np.random.default_rng(SEED + 1)
    runs = [(a, False) for a in list_archs()] + [("whisper-base", True)]
    for arch, memory in runs:
        _run_arch(list_archs().index(arch), arch, memory, rng)


# ---------------------------------------------------------------- specs

def _keys(path):
    return tuple(k.key if hasattr(k, "key") else k.idx for k in path)


def _check_cell(arch, shape, dims, names):
    """The port's ``build_cell`` against the reference's on an abstract
    mesh of ``dims`` (no devices)."""
    rmesh, pmesh = AbstractMesh(dims, names), dict(zip(names, dims))
    _, rargs, rsh, rdonate, rmeta = RSP.build_cell(arch, shape, rmesh)
    _, pargs, psh, pdonate, pmeta = PSP.build_cell(arch, shape, pmesh)
    what = (arch, shape, dims)
    assert pdonate == rdonate and pmeta == rmeta, (what, pmeta, rmeta)
    rleaves = jax.tree_util.tree_flatten_with_path(rargs)[0]
    rspecs = jax.tree.leaves(rsh)
    pleaves = _tree.leaves_with_paths(pargs)
    pspecs = _tree.leaf_nodes(pargs, psh)
    assert len(pleaves) == len(rleaves) == len(rspecs) == len(pspecs), what
    want = 0
    for (rp, r), rs, (pp, p), ps in zip(rleaves, rspecs, pleaves, pspecs):
        assert pp == _keys(rp), (what, pp, _keys(rp))
        assert p.device.type == "meta", (what, pp)
        assert tuple(p.shape) == r.shape, (what, pp, p.shape, r.shape)
        assert str(p.dtype).removeprefix("torch.") == str(r.dtype), (what, pp)
        assert ps == tuple(rs.spec), (what, pp, ps, rs.spec)
        want += math.prod(rs.shard_shape(r.shape)) * r.dtype.itemsize
    assert PSP.rank_bytes(pargs, psh, pmesh) == want, what
    return pargs, psh, pmeta


@contextlib.contextmanager
def _env(**values):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _check_spec_knobs():
    single = ((16, 16), ("data", "model"))
    with _env(REPRO_SHARDING_MODE="replicate"):
        _, psh, _ = _check_cell("whisper-base", "train_4k", *single)
        assert psh[1]["tokens"][0] == ("data", "model")
    with _env(REPRO_LONG_WINDOW="8192"):
        args, _, meta = _check_cell("gemma2-2b", "long_500k", *single)
        assert meta["long_window"] == 8192 and args[1][0]["k"].shape[2] == 8192
    with _env(REPRO_PARAM_DTYPE="bfloat16"):
        args, _, _ = _check_cell("stablelm-1.6b", "prefill_32k", *single)
        assert args[0]["embed"]["table"].dtype == torch.bfloat16
    for micro, want in (("32", 32), ("0", None)):
        with _env(REPRO_MICROBATCH=micro):
            assert _check_cell("gemma2-2b", "train_4k", *single)[2][
                "microbatch"] == want
    for knob in ("REPRO_SHARDING_MODE", "REPRO_LONG_WINDOW",
                 "REPRO_PARAM_DTYPE", "REPRO_MICROBATCH"):
        assert knob not in os.environ, knob


def _check_knob_step(i, env, arch="gemma2-2b", micro=1):
    """One step of a reduced config (f32 compute, dense attention, batch
    ``B`` in microbatches of ``micro``) through both packages under the
    environment ``env`` (a bf16 gradient knob). The port's gradients
    reach the clip as bf16 leaves, where the reference rounds them."""
    rcfg, pcfg = (dataclasses.replace(get(arch, reduced=True),
                                      compute_dtype="float32")
                  for get in (ref_config, port_config))
    rng = np.random.default_rng(SEED + 10 + i)
    batch = {"tokens": rng.integers(1, rcfg.vocab, (B, KNOB_S + 1)).astype(
        np.int32), "mask": (rng.random((B, KNOB_S + 1)) < 0.9).astype(
            np.float32)}
    tree = _params(arch, i, pcfg)
    ropt = RSP.pick_optimizer(ref_config(arch))
    popt = PSP.pick_optimizer(port_config(arch))
    rparams = jax.tree.map(jnp.asarray, tree)
    rstate = RState(rparams, ropt.init(rparams), START_STEP)
    pstate = state_from_numpy(_to_np(rstate), pcfg, device="cpu")
    prev = [_np(x).copy() for x in _tree.leaves(pstate["params"])]
    clip, seen = PTR.clip_by_global_norm, set()

    def spy(grads, max_norm):
        seen.update(g.dtype for g in _tree.leaves(grads))
        return clip(grads, max_norm)
    with _env(**env):
        rstate, rm = jax.jit(r_make_step(rcfg, ropt, microbatch=micro))(
            rstate, jax.tree.map(jnp.asarray, batch))
        step = p_make_step(pcfg, popt, microbatch=micro)
    PTR.clip_by_global_norm = spy
    try:                # the knobs were read when the step was built
        pstate, pm = step(pstate, batch)
    finally:
        PTR.clip_by_global_norm = clip
    what = f"{arch} under {env}"
    assert seen == {torch.bfloat16}, (what, seen)
    _close(float(pm["loss"]), float(rm["loss"]), what + " loss", atol=0)
    _close(float(pm["grad_norm"]), float(rm["grad_norm"]),
           what + " grad norm", atol=0)
    _check_state(what, pstate, rstate, prev, 0, state_rtol=BF16_RTOL)


def _check_collectives():
    """Two cells worked out by hand (mesh sizes as named; f32 leaves, bf16
    activations; the reduced gemma2-2b config: 4 heads of 16).

    Decode, data 2 x model 2, batch 4: ``mlp/wo`` [2 layers, 8, 4] on
    (None, "model", "data"), the embedding [16, 4] on ("model",), a KV
    cache [2, 4, 64, 1, 16] with its sequence on ("data", "model").
    all-gather (data): wo without its data sharding, 2 x 4 x 4 x 4 B =
    128 B, once. all-reduce: wo's output, 2 rows a rank x 4 x 2 B = 16 B
    a layer, 2 layers = 32 B (model); the lookup, 2 x 4 x 4 B = 32 B
    (model); the partial softmax, 4 x 4 x (16 + 2) x 4 B = 1,152 B a
    layer, 2,304 B (data+model). all-reduce 2,368 B in 2 + 1 + 2 = 5.

    Train, pod 2 x data 2 x model 2, batch 8 in microbatches of 2 (4
    microsteps, 1 row a rank), 3 positions: tok = 3. all-gather: 128 B x
    2 passes x 4 = 1,024 B in 8 (data). reduce-scatter: wo's shard 2 x 4
    x 2 x 4 B = 64 B x 4 = 256 B in 4 (data); its pod all-reduce the same,
    256 B in 4 (pod). all-reduce (model): wo's output 3 x 4 x 2 B = 24 B x
    3 passes x 4 x 2 layers = 576 B in 24; the lookup 3 x 4 x 4 B = 48 B
    x 4 = 192 B in 4; the loss 3 x 4 B x 3 x 4 = 144 B in 12; the
    unembedding's input gradient 48 B x 4 = 192 B in 4. The embedding's
    gradient is all-reduced over pod and data: 8 x 4 x 4 B = 128 B x 4 =
    512 B in 4. all-reduce 1,872 B in 52.
    """
    cfg = port_config("gemma2-2b", reduced=True)
    wo = torch.empty((2, 8, 4), device="meta")
    table = torch.empty((16, 4), device="meta")
    params = {"blocks": [{"mlp": {"wo": wo}}], "embed": {"table": table}}
    pspecs = {"blocks": [{"mlp": {"wo": (None, "model", "data")}}],
              "embed": {"table": ("model",)}}
    k = torch.empty((2, 4, 64, 1, 16), dtype=torch.bfloat16, device="meta")
    got = PC.cell_collectives(
        cfg, "decode", (params, [{"k": k, "v": k}], {}),
        (pspecs, [{"k": (None, None, ("data", "model"), None, None),
                   "v": ()}], {}), {"data": 2, "model": 2},
        seq_len=64, global_batch=4)
    assert got["source"] == "placements"
    assert got["per_kind"] == {"all-gather": 128, "all-reduce": 2368}, got
    assert got["counts"] == {"all-gather": 1, "all-reduce": 5}, got
    assert got["per_axes"] == {"data": 128, "model": 64,
                               "data+model": 2304}, got
    got = PC.cell_collectives(
        cfg, "train", ({"params": params}, {}), ({"params": pspecs}, {}),
        {"pod": 2, "data": 2, "model": 2}, seq_len=3, global_batch=8,
        microbatch=2)
    assert got["per_kind"] == {"all-gather": 1024, "reduce-scatter": 256,
                               "all-reduce": 1872}, got
    assert got["counts"] == {"all-gather": 8, "reduce-scatter": 4,
                             "all-reduce": 52}, got
    assert got["per_axes"] == {"data": 1280, "pod": 256, "model": 1104,
                               "pod+data": 512}, got
    assert got["trip_counts"] == {"microsteps": 4, "superblocks": 2}, got


HLO_ARCH = "gemma2-2b"
HLO_MESH = (2, 2)
# (seq_len, global_batch, kind): small enough to compile in seconds
HLO_SHAPES = {"train_s": (64, 8, "train"), "prefill_s": (64, 4, "prefill"),
              "decode_s": (64, 8, "decode")}
HLO_OK = "HLO-COLLECTIVES "


def _hlo_child():
    """The subprocess of ``_check_collectives_hlo`` (four host devices set
    in ``XLA_FLAGS``): each ``HLO_SHAPES`` cell of the reduced ``HLO_ARCH``
    built by both packages' ``build_cell``, the reference's compiled on a
    ``HLO_MESH`` mesh and read by ``collective_bytes`` with the dry run's
    trip counts, the port's counted by ``cell_collectives``. Prints one
    JSON line after ``HLO_OK``."""
    from jax.sharding import AxisType
    from repro.configs import ShapeSpec as RShape
    from repro.distributed.context import data_axes
    from repro.launch.hlo_analysis import collective_bytes
    from repro_torch.configs import ShapeSpec as PShape
    RSP.SHAPES = {k: RShape(k, *v) for k, v in HLO_SHAPES.items()}
    PSP.SHAPES = {k: PShape(k, *v) for k, v in HLO_SHAPES.items()}
    RSP.get_config = lambda a: ref_config(a, reduced=True)
    PSP.get_config = lambda a: port_config(a, reduced=True)
    names = ("data", "model")
    mesh = jax.make_mesh(HLO_MESH, names, axis_types=(AxisType.Auto,) * 2)
    sizes = dict(zip(names, HLO_MESH))
    cfg = port_config(HLO_ARCH, reduced=True)
    out = {}
    for shape, (S, batch, kind) in HLO_SHAPES.items():
        fn, args, shs, donate, meta = RSP.build_cell(HLO_ARCH, shape, mesh)
        with mesh, data_axes(["data"], sizes["data"]):
            hlo = jax.jit(fn, in_shardings=shs, donate_argnums=donate).lower(
                *args).compile().as_text()
        micro = meta.get("microbatch")
        inner = max(S // 512, 1)
        trips = (([batch // micro] if micro else [])
                 + [cfg.n_superblocks, inner, inner])
        per_kind, _, counts = collective_bytes(hlo, trips)
        _, pargs, psh, _, pmeta = PSP.build_cell(HLO_ARCH, shape, sizes)
        got = PC.cell_collectives(cfg, kind, pargs, psh, sizes, seq_len=S,
                                  global_batch=batch,
                                  microbatch=pmeta.get("microbatch"))
        out[shape] = {"ref": per_kind, "ref_counts": counts,
                      "port": got["per_kind"], "port_counts": got["counts"]}
    print(HLO_OK + json.dumps(out), flush=True)


def _check_collectives_hlo():
    """``cell_collectives`` against the reference's compiled HLO for the
    ``HLO_SHAPES`` cells of the reduced gemma2-2b (bf16 compute, f32
    leaves) on a data 2 x model 2 host mesh. XLA needs its device count
    before it starts, so the reference compiles in a subprocess.

    What holds exactly: the FSDP all-gathers of training and prefill
    (589,824 B in 28 and 294,912 B in 14). The gaps, as this version of
    XLA's CPU backend compiles the cells:

    * decode: the model gathers every data-sharded weight (294,912 B);
      XLA gathers 208,896 B, moving the small decode activations into the
      row-parallel products instead of gathering their weights, and adds
      all-to-alls to reshard them. The model counts more;
    * all-reduce: XLA's CPU backend computes bf16 products in f32 and
      reduces the f32 result (prefill 294,912 B against the model's
      163,840, exactly the f32 width of the same reductions); in training
      it also reduces the input gradients of q, k, v and of the two MLP
      inputs one by one and reduces whole gradients where the model has
      a reduce-scatter (2,790,780 B against 988,416 + 147,456). The model
      counts less.

    So the check holds the gathers to equality and the other terms to the
    direction of their gap."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_force_host_"
                        f"platform_device_count={math.prod(HLO_MESH)}")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, __file__, "--hlo-child"],
                          capture_output=True, text=True, timeout=300,
                          env=env)
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith(HLO_OK)]
    assert proc.returncode == 0 and line, proc.stdout + proc.stderr
    cells = json.loads(line[0][len(HLO_OK):])
    rest = ("reduce-scatter", "all-reduce", "all-to-all",
            "collective-permute")
    for shape, c in cells.items():
        ref, port = c["ref"], c["port"]
        if shape == "decode_s":
            assert 0 < ref["all-gather"] < port["all-gather"], (shape, c)
        else:
            assert ref["all-gather"] == port["all-gather"], (shape, c)
            assert c["ref_counts"]["all-gather"] == \
                c["port_counts"]["all-gather"], (shape, c)
        assert sum(port.get(k, 0) for k in rest) < sum(
            ref.get(k, 0) for k in rest), (shape, c)


def check_specs():
    rmesh = jax.make_mesh((1, 1), ("data", "model"))
    assert set(P_SHAPES) == set(R_SHAPES)
    for arch in list_archs():
        rcfg, pcfg = ref_config(arch), port_config(arch)
        assert PSP.pick_optimizer(pcfg).name == RSP.pick_optimizer(
            rcfg).name, arch
        for shape in P_SHAPES:
            want = RSP.input_specs(arch, shape)
            got = PSP.input_specs(arch, shape)
            assert list(got) == list(want), (arch, shape)
            for k, (shp, dt) in got.items():
                assert shp == want[k].shape, (arch, shape, k)
                assert str(dt).removeprefix("torch.") == str(
                    want[k].dtype), (arch, shape, k)
            spec = P_SHAPES[shape]
            if spec.kind == "train":
                meta = RSP.build_cell(arch, shape, rmesh)[-1]
                assert PSP.train_microbatch(
                    pcfg, spec.global_batch, 1) == meta["microbatch"], arch
            _check_cell(arch, shape, (16, 16), ("data", "model"))
        _check_cell(arch, "train_4k", (2, 16, 16), ("pod", "data", "model"))
    for name in ("GIANT_PARAM_THRESHOLD", "ENC_FRAMES", "VIS_TOKENS"):
        assert getattr(PSP, name) == getattr(RSP, name), name
    # more data shards than the one-device mesh: the rule, by its numbers
    for arch, dshards, want in (("qwen2-vl-72b", 16, 16),
                                ("dbrx-132b", 16, 32),
                                ("starcoder2-15b", 48, 1),
                                ("gemma2-2b", 16, None)):
        assert PSP.train_microbatch(port_config(arch), 256,
                                    dshards) == want, arch
    _check_spec_knobs()
    for i, env in enumerate(({"REPRO_ACCUM_DTYPE": "bf16"},
                             {"REPRO_GRAD_AR_DTYPE": "bf16"})):
        _check_knob_step(i, env)
    _check_collectives()
    _check_collectives_hlo()


def check_optimizers_and_train_steps():
    check_optimizers()
    check_specs()
    check_train_steps()
    jax.clear_caches()      # the worker's memory maps (ROADMAP queue 3d)


# ---------------------------------------------------------------- launcher

def check_launcher_archs(tmp_path):
    for arch in ("whisper-base", "jamba-1.5-large-398b"):
        ckpt = str(tmp_path / arch)
        out = LT.main(["--arch", arch, "--reduced", "--steps", "2",
                       "--batch", "2", "--seq", "32", "--ckpt-every", "2",
                       "--log-every", "100", "--device", "cpu", "--ckpt",
                       ckpt])
        assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
        rcfg = ref_config(arch, reduced=True)
        like = jax.eval_shape(lambda k: RState(
            RT.init_lm(k, rcfg), r_adamw(1e-3).init(RT.init_lm(k, rcfg)), 0),
            jax.random.PRNGKey(0))
        tree, extra, step = r_restore(ckpt, like)
        assert step == 2 and extra == {"data_step": 2}
        for got, want in zip(jax.tree.leaves(tree),
                             _tree.leaves(out["state"])):
            assert np.array_equal(np.asarray(got), _np(want)), arch
    _check_dryrun(tmp_path / "dryrun")
    jax.clear_caches()


def _check_dryrun(out):
    """``run_cell`` on two cells: the record's keys and H100 figures, its
    bytes against ``build_cell``'s, and a second call reading it back."""
    for arch, shape, multi in (("whisper-base", "decode_32k", False),
                               ("dbrx-132b", "train_4k", True)):
        rec = PDR.run_cell(arch, shape, multi, str(out))
        assert rec["ok"], rec.get("error")
        mesh = {"pod": 2, "data": 16, "model": 16} if multi else {
            "data": 16, "model": 16}
        assert rec["mesh"] == mesh and rec["chips"] == math.prod(
            mesh.values())
        _, args, specs, _, _ = PSP.build_cell(arch, shape, mesh)
        assert rec["arg_bytes"]["total"] == PSP.rank_bytes(args, specs,
                                                           mesh)
        assert rec["memory_analysis"]["argument_size_in_bytes"] == \
            rec["arg_bytes"]["total"]
        assert rec["memory_analysis"]["temp_size_in_bytes"] is None
        assert rec["collectives"]["source"] == "placements"
        assert rec["roofline"]["hardware"]["peak_flops"] == 989.4e12
        assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                               "collective_s")
        for key in ("cell", "arch", "shape", "kind", "seq_len",
                    "global_batch", "n_superblocks", "params",
                    "active_params", "lower_s", "analytic"):
            assert key in rec, key
        assert PDR.run_cell(arch, shape, multi, str(out)) == rec


# ---------------------------------------------------------------- by name

def test_optimizers_and_train_steps():
    check_optimizers_and_train_steps()


def test_launcher_archs(tmp_path):
    check_launcher_archs(tmp_path)


if __name__ == "__main__" and "--hlo-child" in sys.argv:
    _hlo_child()
