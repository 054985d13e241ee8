"""Port parity: LM serving on the Roaring-paged KV cache.

One test item (the tier-1 memory-map budget holds the suite to 383
collected tests; see ROADMAP queue 3). Against the reference package, on
reduced gemma2-2b (G = 2, softcap, window 64) and reduced stablelm-1.6b
(G = 1), both with float32 compute:

* the port's plain paged decode against the Pallas kernel in interpret
  mode and against the reference's own plain version;
* ``decode_step_paged`` logits and pools, on inputs whose write targets are
  distinct;
* the page table's lists over one alloc / release sequence, exactly, and
  at its end the device views (``free_slab``, ``used_slab``,
  ``rebuild_free_slab``, ``shared_pages*``) as serialized bytes and counts,
  and ``audit`` reports on the table and on a table with a leaked page;
* the port's engine against the reference's engine at ``max_batch=1``,
  with its ``serve.step`` span and ``serve.*`` gauges;
* the port's engine at ``max_batch`` 2 and 4 against greedy over the
  reference's teacher-forced ``forward``, and the port's ``forward``
  against the reference's;
* the other architectures of the registry (``_torch_archs.
  check_decode_and_engine``): ``decode_step`` on every reduced config,
  ``decode_step_paged`` on the attention-only ones, the engine on reduced
  dbrx-132b and llama4, ``PagedKVCache``.

Inputs come from a seed with numpy; the reference's parameters reach the
port through ``models.convert``. Tolerances: float32 results computed in
another order agree to ``ATOL`` / ``RTOL``; a greedy token is compared
wherever the reference's top-2 logit gap is at least ``GAP``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_archs import check_decode_and_engine
from _torch_parity import release_jax_executables  # noqa: F401
from _torch_threads import share_cores_between_workers
from repro.configs import get_config as ref_config
from repro.kernels.sparse_attn import kernel as RK
from repro.kernels.sparse_attn import ref as RR
from repro.models import transformer as RT
from repro.serve import Request as RRequest
from repro.serve import RoaringPageTable as RTable
from repro.serve import ServeEngine as REngine
from repro_torch import obs
from repro_torch.configs import get_config as port_config
from repro_torch.kernels.sparse_attn import cases
from repro_torch.kernels.sparse_attn import ref as PR
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Request as PRequest
from repro_torch.serve import RoaringPageTable as PTable
from repro_torch.serve import ServeEngine as PEngine

share_cores_between_workers()

SEED = 1402
ATOL, RTOL = 2e-5, 2e-4      # float32, sums taken in another order
GAP = 1e-4                   # greedy steps closer than this are near-ties
ARCHS = ("gemma2-2b", "stablelm-1.6b")


def _configs(arch):
    """(reference cfg, port cfg), reduced, float32 compute."""
    return tuple(dataclasses.replace(get(arch, reduced=True),
                                     compute_dtype="float32")
                 for get in (ref_config, port_config))


def _reach(cfg):
    """A length past the sliding window on local / global patterns (so
    local layers see ``starts > 0``); a short one otherwise."""
    return cfg.window if cfg.layer_pattern == "local_global" else 24


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=ATOL,
                               rtol=RTOL, err_msg=what)


def test_serving_path_matches_reference():
    rng = np.random.default_rng(SEED)
    # stablelm-1.6b's and a small head dim, then the registry's starcoder2
    # (12 query heads a KV head) and stablelm-3b (D = 80) pairs
    for G, D, page, softcap in ((1, 64, 8, None), (2, 16, 4, 50.0),
                                (12, 128, 16, None), (1, 80, 8, 50.0)):
        _check_paged_decode(rng, G, D, page, softcap)
    _check_page_table(rng)
    for i, arch in enumerate(ARCHS):
        rcfg, pcfg = _configs(arch)
        rparams = RT.init_lm(jax.random.PRNGKey(SEED + i), rcfg)
        pparams = params_from_numpy(jax.tree.map(np.asarray, rparams), pcfg,
                                    device="cpu")
        _check_decode_step(rng, rcfg, pcfg, rparams, pparams)
        prompts = _prompts(rng, rcfg)
        _check_engine_batch1(rcfg, pcfg, rparams, pparams, prompts[:2])
        _check_engine_vs_forward(rcfg, pcfg, rparams, pparams, prompts)
    check_decode_and_engine()


# ---------------------------------------------------------------- kernel level

def _check_paged_decode(rng, G, D, page, softcap):
    """``cases.paged_decode_case``: rows with ``starts > 0``, an empty row,
    and NaN in the pages after each row's ``counts``."""
    c = cases.paged_decode_case(rng, G, D, page, KVH=2, max_pages=6)
    q, kp, vp = c["q"], c["k_pages"], c["v_pages"]
    args = tuple(c[k] for k in ("page_idx", "counts", "lengths", "starts"))
    port = PR.paged_decode_ref(_t(q), _t(kp), _t(vp),
                               *map(_t, args), softcap=softcap).numpy()
    assert np.isfinite(port).all() and not port[c["counts"] == 0].any()
    pallas = RK.paged_decode_attention(q, kp, vp, *args, softcap=softcap,
                                       interpret=True)
    _close(port, pallas, f"paged decode vs Pallas (G={G}, D={D})")
    # the reference's plain version reads every listed page and averages
    # V on a row with nothing live: compare the live rows, without NaN
    kz, vz = np.nan_to_num(kp), np.nan_to_num(vp)
    want = np.asarray(RR.paged_decode_ref(q, kz, vz, *args, softcap=softcap))
    got = PR.paged_decode_ref(_t(q), _t(kz), _t(vz), *map(_t, args),
                              softcap=softcap).numpy()
    live = c["counts"] > 0
    _close(got[live], want[live], f"paged decode vs reference plain "
           f"version (G={G}, D={D})")


def _check_page_table(rng):
    ref, port = RTable(40, 4), PTable(40, 4, device="cpu")
    for _ in range(60):
        sid = int(rng.integers(0, 5))
        if rng.random() < 0.25:
            ref.release(sid)
            port.release(sid)
        else:
            n = int(rng.integers(1, 9))
            try:
                want = ref.alloc(sid, n)
            except MemoryError:
                with pytest.raises(MemoryError):
                    port.alloc(sid, n)
                continue
            assert port.alloc(sid, n) == want
        assert port.seq_pages == ref.seq_pages
        assert port.seq_len == ref.seq_len
        assert np.array_equal(port.free.to_array(), ref.free.to_array())
        assert port.free.kind_stats() == ref.free.kind_stats()
        assert port.utilization() == ref.utilization()
        assert np.array_equal(port.used_bitmap().to_array(),
                              ref.used_bitmap().to_array())
        for a, b in zip(port.gather_lists(list(range(5)), 16),
                        ref.gather_lists(list(range(5)), 16)):
            assert np.array_equal(a, b)
    _check_page_views(ref, port)
    fresh = PTable(40, 4, device="cpu")        # no sequences: one free run
    assert fresh.used_slab().serialize() == RTable(40, 4).used_slab(
        ).serialize()
    assert fresh.rebuild_free_slab().serialize() == \
        fresh.free_slab().serialize()


def _check_page_views(ref, port):
    for view in ("free_slab", "used_slab", "rebuild_free_slab"):
        assert getattr(port, view)().serialize() == \
            getattr(ref, view)().serialize(), view
    live = sorted(ref.seq_pages)
    assert live, "the alloc / release sequence left no sequence"
    a, b = live[0], live[-1]
    assert port.shared_pages(a, b) == ref.shared_pages(a, b)
    assert np.array_equal(port.shared_pages_many(a, live),
                          np.asarray(ref.shared_pages_many(a, live)))
    for table in (ref, port):
        assert table.audit().ok, table.audit().summary()
        table.seq_pages[a].pop()               # leak one page
    codes = [[v.code for v in t.audit().violations] for t in (ref, port)]
    assert codes[0] == codes[1] and "page-leak" in codes[1]


# ---------------------------------------------------------------- model level

def _check_decode_step(rng, rcfg, pcfg, rparams, pparams):
    """Pre-filled random pools; rows at positions past the window (local
    layers see ``starts > 0``), each writing into a page of its own."""
    page, max_pages = 8, 16
    pos = np.asarray([_reach(rcfg) + 13, 5, _reach(rcfg) + 40], np.int32)
    B = len(pos)
    counts = (pos // page + 1).astype(np.int32)
    P = int(counts.sum()) + 4
    perm = rng.permutation(P)
    page_idx = np.zeros((B, max_pages), np.int32)
    used = 0
    for b in range(B):
        page_idx[b, :counts[b]] = perm[used:used + counts[b]]
        used += counts[b]
    pools = [{k: rng.standard_normal(
        (rcfg.n_superblocks, P, page, rcfg.n_kv_heads, rcfg.hd)
    ).astype(np.float32) for k in ("k", "v")} for _ in rcfg.block_kinds()]
    tokens = rng.integers(0, rcfg.vocab, (B, 1)).astype(np.int32)
    want_logits, want_pools = RT.decode_step_paged(
        rparams, [{k: jax.numpy.asarray(v) for k, v in p.items()}
                  for p in pools], tokens, pos, page_idx, counts, pos, rcfg)
    port_pools = [{k: _t(v.copy()) for k, v in p.items()} for p in pools]
    logits, out_pools = PT.decode_step_paged(
        pparams, port_pools, _t(tokens), _t(pos), _t(page_idx), _t(counts),
        _t(pos), pcfg)
    assert out_pools is port_pools
    _close(logits.numpy(), want_logits, f"{rcfg.name} decode logits")
    for got, want in zip(out_pools, want_pools):
        for k in ("k", "v"):
            _close(got[k].numpy(), want[k], f"{rcfg.name} decode pool {k}")


def _prompts(rng, cfg):
    """One prompt longer than the window (``_reach``), then short ones."""
    lens = [_reach(cfg) + 6, 5, 3, 9, 6]
    return [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in lens]


def _serve(engine_cls, request_cls, cfg, params, prompts, max_batch,
           max_new, return_engine=False, **kw):
    eng = engine_cls(cfg, params, max_batch=max_batch, n_pages=96,
                     page_size=4, max_pages_per_seq=24, **kw)
    reqs = [request_cls(req_id=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done(max_steps=500)
    assert all(r.done and len(r.generated) == max_new for r in reqs)
    assert eng.table.utilization() == 0.0 and not eng.table.seq_pages
    got = [r.generated for r in reqs]
    return (got, eng) if return_engine else got


def _check_engine_batch1(rcfg, pcfg, rparams, pparams, prompts):
    """Same tokens as the reference's engine; with telemetry on, one
    ``serve.step`` span per engine step and the ``serve.*`` gauges."""
    want = _serve(REngine, RRequest, rcfg, rparams, prompts, 1, 8)
    obs.reset_traces()
    obs.reset_metrics()
    with obs.telemetry_scope(True):
        got, eng = _serve(PEngine, PRequest, pcfg, pparams, prompts, 1, 8,
                          device="cpu", return_engine=True)
    assert got == want, (rcfg.name, got, want)
    spans = [s for s in obs.span_trees() if s.name == "serve.step"]
    reg = obs.registry()
    assert spans and reg.value("serve.steps") == eng.steps_run
    assert reg.value("serve.page_pool.free_pages") == eng.table.n_pages
    assert reg.value("serve.queue_depth") == 0


def _check_engine_vs_forward(rcfg, pcfg, rparams, pparams, prompts):
    max_new = 6
    runs = {mb: _serve(PEngine, PRequest, pcfg, pparams, prompts, mb,
                       max_new, device="cpu") for mb in (2, 4)}
    seqs = [np.concatenate([p, g[:-1]]) for mb in runs
            for p, g in zip(prompts, runs[mb])]
    S = max(len(s) for s in seqs)
    tokens = np.zeros((len(seqs), S), np.int32)      # causal: the tail pad
    for i, s in enumerate(seqs):                     # never reaches a token
        tokens[i, :len(s)] = s
    want, _ = RT.forward(rparams, tokens, rcfg)
    want = np.asarray(want, np.float32)
    got, _ = PT.forward(pparams, _t(tokens), pcfg)
    _close(got.numpy(), want, f"{rcfg.name} forward logits")
    near_ties = 0
    for i, (mb, j) in enumerate((mb, j) for mb in runs
                                for j in range(len(prompts))):
        start = len(prompts[j]) - 1
        for step, tok in enumerate(runs[mb][j]):
            row = want[i, start + step]
            top2 = np.sort(row)[-2:]
            if top2[1] - top2[0] < GAP:
                near_ties += 1
                continue
            assert tok == int(np.argmax(row)), (
                f"{rcfg.name} max_batch={mb} request {j} step {step}: "
                f"engine {tok}, teacher-forced greedy {int(np.argmax(row))}")
    assert near_ties <= 2, f"{near_ties} near-ties: the check lost its power"
