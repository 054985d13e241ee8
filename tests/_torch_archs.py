"""Port parity: the ten architectures of the model registry, reduced.

The checks run inside existing test items (the tier-1 memory-map budget
holds the suite to 383 collected tests; see ROADMAP queue 3d):
``check_forward_and_encode`` in ``test_torch_train.py::
test_attention_masks_and_data_match_reference`` and
``check_decode_and_engine`` in ``test_torch_serve.py::
test_serving_path_matches_reference``. Named on the command line, this
file runs the same checks as two tests:

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/_torch_archs.py

Every reduced config runs in float32 compute, both packages from the same
parameters (the port's ``init_lm`` draw, whose tree has the reference's
structure, shapes and dtypes, carried over by ``models.convert.
params_from_numpy``), against the JAX package run as its own tests run it
(eagerly, on the CPU):

* ``forward`` logits and aux loss (qwen2-vl with 8 stub patch embeddings,
  whisper with the encoder's output as memory), ``lm_loss`` and ``encode``;
* MoE routing of dbrx, llama4 and jamba on inputs with exact router ties
  (two zero router columns) and capacity overflow: the gate indices equal
  ``jax.lax.top_k``'s, and the capacity slots and keep mask equal the
  reference's definition (an exclusive count per expert in pair order)
  exactly; the MoE output and aux loss within tolerance;
* three ``decode_step`` calls per config, one row past the cache's end (the
  write clamps), logits and every cache leaf after each;
* one ``decode_step_paged`` on every attention-only pattern, logits and
  pools;
* the port's ``ServeEngine`` gives the reference engine's tokens for
  reduced dbrx-132b and llama4 at ``max_batch=1`` (the reference's engine
  overwrites page 0 above that, ROADMAP queue 3c);
* ``PagedKVCache.write_token`` equals the reference's exactly;
* ``decode_step(write=)`` equals ``decode_step_paged(write=)`` on reduced
  dbrx-132b (a row that writes and one that does not, MoE on both), as
  the card's dbrx serving check relies on.

Tolerances: float32 results computed in another order agree to ``ATOL`` /
``RTOL`` (the serving tests' values); routing is compared exactly.
"""

import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.configs import list_archs as ref_archs
from repro.models import mlp as RM
from repro.models import transformer as RT
from repro.serve import PagedKVCache as RCache
from repro.serve import Request as RRequest
from repro.serve import ServeEngine as REngine
from repro_torch.configs import get_config as port_config
from repro_torch.configs import list_archs as port_archs
from repro_torch.models import mlp as PM
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import PagedKVCache as PCache
from repro_torch.serve import Request as PRequest
from repro_torch.serve import ServeEngine as PEngine

SEED = 1419
ATOL, RTOL = 2e-5, 2e-4
B, S = 2, 16
VIS_PATCHES, ENC_FRAMES = 8, 12
ENGINE_ARCHS = ("dbrx-132b", "llama4-maverick-400b-a17b")


def _configs(arch):
    """(reference cfg, port cfg), reduced, float32 compute."""
    return tuple(dataclasses.replace(get(arch, reduced=True),
                                     compute_dtype="float32")
                 for get in (ref_config, port_config))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, what):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=ATOL,
                               rtol=RTOL, err_msg=what)


def _models(arch, i):
    """Both packages' parameters from the same numbers: the port's
    ``init_lm`` draw (on the CPU), whose tree must have the reference's
    structure, leaf shapes and dtypes, handed to the reference as arrays
    and to the port through ``params_from_numpy``. (Drawing with the
    reference's eager ``init_lm`` costs ~2 s of XLA compiles a config.)"""
    rcfg, pcfg = _configs(arch)
    tree = jax.tree.map(lambda t: t.numpy(),
                        PT.init_lm(pcfg, SEED + i, device="cpu"))
    want = jax.eval_shape(lambda k: RT.init_lm(k, rcfg),
                          jax.random.PRNGKey(0))
    assert jax.tree.structure(tree) == jax.tree.structure(want), arch
    for got, w in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        assert got.shape == w.shape and got.dtype == w.dtype, arch
    rparams = jax.tree.map(jax.numpy.asarray, tree)
    return rcfg, pcfg, rparams, params_from_numpy(tree, pcfg, device="cpu")


def _attention_only(cfg):
    return all(k.startswith("attn") for k in cfg.block_kinds())


def _memory(rng, rcfg, rparams, pcfg, pparams):
    """whisper: (reference memory, port memory) from ``encode`` over stub
    frames, checked against each other; (None, None) otherwise."""
    if rcfg.layer_pattern != "encdec":
        return None, None
    frames = rng.standard_normal((B, ENC_FRAMES, rcfg.d_model)).astype(
        np.float32)
    want = np.asarray(RT.encode(rparams, frames, rcfg))
    got = PT.encode(pparams, _t(frames), pcfg)
    _close(got, want, f"{rcfg.name} encode")
    return want, _t(want)


# ---------------------------------------------------------------- forward

def check_forward_and_encode():
    assert port_archs() == ref_archs()
    rng = np.random.default_rng(SEED)
    for i, arch in enumerate(port_archs()):
        rcfg, pcfg, rparams, pparams = _models(arch, i)
        tokens = rng.integers(0, rcfg.vocab, (B, S)).astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        extra = None
        if rcfg.frontend == "vision":
            extra = rng.standard_normal(
                (B, VIS_PATCHES, rcfg.d_model)).astype(np.float32)
        rmem, pmem = _memory(rng, rcfg, rparams, pcfg, pparams)
        kw = dict(extra_embeds=extra, memory=rmem)
        pkw = dict(extra_embeds=None if extra is None else _t(extra),
                   memory=pmem)
        want, want_aux = RT.forward(rparams, tokens, rcfg, **kw)
        got, got_aux = PT.forward(pparams, _t(tokens), pcfg, **pkw)
        assert got.shape == (B, S, pcfg.vocab_padded)
        _close(got, want, f"{arch} forward logits")
        _close(got_aux, want_aux, f"{arch} forward aux loss")
        if pcfg.n_experts:
            assert float(got_aux) > 0, arch
        _close(PT.lm_loss(pparams, _t(tokens), _t(labels), pcfg, **pkw),
               RT.lm_loss(rparams, tokens, labels, rcfg, **kw),
               f"{arch} lm_loss")
        for j, kind in enumerate(rcfg.block_kinds()):
            if kind.endswith("_moe"):
                _check_routing(rng, rcfg, pcfg, rparams["blocks"][j]["moe"],
                               pparams["blocks"][j]["moe"])
                break
    jax.clear_caches()      # the worker's memory maps (ROADMAP queue 3d)


def _check_routing(rng, rcfg, pcfg, rmoe, pmoe):
    """One MoE layer of the first super-block on random tokens, with router
    columns 0 and 1 zeroed (their logits tie exactly, so ``top_k`` must
    break the tie toward expert 0) and enough tokens that expert 0
    overflows its capacity."""
    E, K = rcfg.n_experts, rcfg.top_k
    layer = {k: np.array(np.asarray(v)[0]) for k, v in rmoe.items()}
    layer["router"][:, :2] = 0.0
    x = rng.standard_normal((4, 16, rcfg.d_model)).astype(np.float32)
    seen = []
    top_k = jax.lax.top_k

    def spy(a, k):
        out = top_k(a, k)
        seen.append(np.asarray(out[1]))
        return out
    jax.lax.top_k = spy
    try:
        want, want_aux = RM.moe(layer, x, rcfg)
    finally:
        jax.lax.top_k = top_k
    gate_idx = seen[0]
    player = {k: _t(v) for k, v in layer.items()}
    got, got_aux = PM.moe(player, _t(x), pcfg)
    _close(got, want, f"{rcfg.name} moe output")
    _close(got_aux, want_aux, f"{rcfg.name} moe aux loss")
    N = x.shape[0] * x.shape[1]
    _, _, p_idx, p_slot, p_keep, C = PM.route(
        player["router"], _t(x.reshape(N, -1)), pcfg)
    assert np.array_equal(p_idx.numpy(), gate_idx), rcfg.name
    # the definition: a pair's slot counts the earlier pairs (token-major,
    # k-minor) routed to the same expert
    pairs = gate_idx.reshape(-1)
    slot = np.array([np.sum(pairs[:n] == e) for n, e in enumerate(pairs)])
    assert np.array_equal(p_slot.numpy().reshape(-1), slot), rcfg.name
    assert np.array_equal(p_keep.numpy().reshape(-1), slot < C), rcfg.name
    assert C == max(1, int(np.ceil(rcfg.capacity_factor * N * K / E)))
    assert (slot >= C).any(), f"{rcfg.name}: no pair overflowed"
    if K > 1:       # a tie between experts 0 and 1 inside the top k
        both = (gate_idx[:, :-1] == 0) & (gate_idx[:, 1:] == 1)
        assert both.any() and not ((gate_idx[:, :-1] == 1)
                                   & (gate_idx[:, 1:] == 0)).any()


# ---------------------------------------------------------------- decode

def check_decode_and_engine():
    rng = np.random.default_rng(SEED + 1)
    for i, arch in enumerate(port_archs()):
        rcfg, pcfg, rparams, pparams = _models(arch, i)
        rmem, pmem = _memory(rng, rcfg, rparams, pcfg, pparams)
        _check_decode(rng, rcfg, pcfg, rparams, pparams, rmem, pmem)
        if _attention_only(rcfg):
            _check_decode_paged(rng, rcfg, pcfg, rparams, pparams)
        if arch in ENGINE_ARCHS:
            _check_engine(rng, rcfg, pcfg, rparams, pparams)
        if arch == "dbrx-132b":
            _check_write_mask(rng, pcfg, pparams)
    _check_kv_cache(rng)
    jax.clear_caches()      # the worker's memory maps (ROADMAP queue 3d)


def _check_decode(rng, rcfg, pcfg, rparams, pparams, rmem, pmem,
                  s_max=8, steps=3):
    """Three steps from zero caches; row 1 runs past ``s_max`` (the
    reference's ``dynamic_update_slice`` clamps the write)."""
    rc = RT.init_decode_caches(rcfg, B, s_max)
    pc = PT.init_decode_caches(pcfg, B, s_max, device="cpu")
    pos = np.asarray([1, s_max - 2], np.int32)
    for step in range(steps):
        tok = rng.integers(0, rcfg.vocab, (B, 1)).astype(np.int32)
        want, rc = RT.decode_step(rparams, rc, tok, pos, rcfg, memory=rmem)
        got, out = PT.decode_step(pparams, pc, _t(tok), _t(pos), pcfg,
                                  memory=pmem)
        assert out is pc
        what = f"{rcfg.name} decode step {step}"
        _close(got, want, what + " logits")
        for j, (g, w) in enumerate(zip(pc, rc)):
            assert set(g) == set(w), what
            for k in g:
                _close(g[k], w[k], f"{what} cache {j} {k}")
        pos = pos + 1


def _check_decode_paged(rng, rcfg, pcfg, rparams, pparams, page=4):
    """One step over pre-filled random pools, each row writing into a page
    of its own."""
    pos = np.asarray([6, 13], np.int32)
    counts = (pos // page + 1).astype(np.int32)
    P = int(counts.sum()) + 3
    perm = rng.permutation(P)
    page_idx = np.zeros((B, 8), np.int32)
    page_idx[0, :counts[0]] = perm[:counts[0]]
    page_idx[1, :counts[1]] = perm[counts[0]:counts.sum()]
    pools = [{k: rng.standard_normal(
        (rcfg.n_superblocks, P, page, rcfg.n_kv_heads, rcfg.hd)
    ).astype(np.float32) for k in ("k", "v")} for _ in rcfg.block_kinds()]
    tok = rng.integers(0, rcfg.vocab, (B, 1)).astype(np.int32)
    want, want_pools = RT.decode_step_paged(
        rparams, [{k: jax.numpy.asarray(v) for k, v in p.items()}
                  for p in pools], tok, pos, page_idx, counts, pos, rcfg)
    got, got_pools = PT.decode_step_paged(
        pparams, [{k: _t(v.copy()) for k, v in p.items()} for p in pools],
        _t(tok), _t(pos), _t(page_idx), _t(counts), _t(pos), pcfg)
    _close(got, want, f"{rcfg.name} paged decode logits")
    for g, w in zip(got_pools, want_pools):
        for k in ("k", "v"):
            _close(g[k], w[k], f"{rcfg.name} paged decode pool {k}")


def _serve(engine_cls, request_cls, cfg, params, prompts, **kw):
    eng = engine_cls(cfg, params, max_batch=1, n_pages=64, page_size=4,
                     max_pages_per_seq=16, **kw)
    reqs = [request_cls(req_id=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done(max_steps=200)
    assert all(r.done for r in reqs)
    assert eng.table.utilization() == 0.0
    return [r.generated for r in reqs]


def _check_engine(rng, rcfg, pcfg, rparams, pparams):
    prompts = [rng.integers(1, rcfg.vocab, n).astype(np.int32)
               for n in (7, 4, 10)]
    want = _serve(REngine, RRequest, rcfg, rparams, prompts)
    got = _serve(PEngine, PRequest, pcfg, pparams, prompts, device="cpu")
    assert got == want, (rcfg.name, got, want)


def _check_write_mask(rng, cfg, params, page=4):
    """Row 0 advances (writes its K/V at ``pos``), row 1 does not (stores
    nothing, attends to positions ``< pos``): the dense-cache step and the
    paged step give the same logits and leave row 1's caches alone."""
    pos = np.asarray([6, 9], np.int32)
    kinds = cfg.block_kinds()
    n_sb, KVH, hd = cfg.n_superblocks, cfg.n_kv_heads, cfg.hd
    hist = [{k: rng.standard_normal((n_sb, B, 16, KVH, hd)).astype(
        np.float32) for k in ("k", "v")} for _ in kinds]
    dense = [{k: _t(v.copy()) for k, v in h.items()} for h in hist]
    counts = np.asarray([pos[0] // page + 1, -(-pos[1] // page)], np.int32)
    page_idx = np.zeros((B, 4), np.int32)
    page_idx[0, :counts[0]] = np.arange(counts[0])
    page_idx[1, :counts[1]] = counts[0] + np.arange(counts[1])
    P = int(counts.sum())
    pools = []
    for h in hist:
        pool = {}
        for k, a in h.items():
            p = np.zeros((n_sb, P, page, KVH, hd), np.float32)
            for b in range(B):
                for t in range(counts[b] * page):
                    p[:, page_idx[b, t // page], t % page] = a[:, b, t]
            pool[k] = _t(p)
        pools.append(pool)
    tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    write = torch.tensor([True, False])
    got, _ = PT.decode_step(params, dense, _t(tok), _t(pos), cfg,
                            write=write)
    lengths = np.asarray([pos[0], pos[1] - 1], np.int32)
    want, _ = PT.decode_step_paged(params, pools, _t(tok), _t(pos),
                                   _t(page_idx), _t(counts), _t(lengths),
                                   cfg, write=write)
    _close(got, want.numpy(), "decode_step(write=) vs decode_step_paged")
    for h, c in zip(hist, dense):
        for k in ("k", "v"):
            assert np.array_equal(c[k][:, 1].numpy(), h[k][:, 1])
            assert not np.array_equal(c[k][:, 0].numpy(), h[k][:, 0])


def _check_kv_cache(rng):
    L, P, page, KVH, hd, n = 2, 6, 4, 2, 8, 3
    ref = RCache.create(L, P, page, KVH, hd, dtype=jax.numpy.float32)
    port = PCache.create(L, P, page, KVH, hd, dtype=torch.float32,
                         device="cpu")
    for _ in range(3):
        ks, vs = (rng.standard_normal((L, n, KVH, hd)).astype(np.float32)
                  for _ in range(2))
        pid = rng.choice(P, n, replace=False).astype(np.int32)
        off = rng.integers(0, page, n).astype(np.int32)
        ref = ref.write_token(ks, vs, pid, off)
        assert port.write_token(ks, vs, pid, off) is port
        for k in ("k", "v"):
            assert np.array_equal(getattr(port, k).numpy(),
                                  np.asarray(getattr(ref, k))), k
    assert port.page_size == ref.page_size


# ---------------------------------------------------------------- by name

def test_forward_and_encode():
    check_forward_and_encode()


def test_decode_and_engine():
    check_decode_and_engine()
