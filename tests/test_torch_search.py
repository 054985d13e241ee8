"""Port parity: the search service end to end, plus the import guard.

A reference ``repro.search.PostingIndex`` is carried into the port with
``PostingIndex.from_arrays`` (the exact slab bytes), and the port's service
must answer count / docs / topk exactly as the reference service does —
fused and per-op, batched and sequential — and as a brute-force numpy
oracle. The ladder, the LRU cache and the launch accounting are checked on
the port alone (on the CPU the entry points run the plain versions).
Inside the ``from_postings`` item, ``PostingIndex.shard`` over two gloo
ranks (an odd row count, so one padding row) answers top-k as the
reference's unsharded index does
(``_torch_distributed.check_two_rank_search``).
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_distributed import check_two_rank_search
from _torch_parity import release_jax_executables, slab_leaves  # noqa: F401
from repro import search as JS
from repro_torch import obs
from repro_torch import search as TS
from repro_torch.runtime import FaultPlan, fault_scope

ROOT = Path(__file__).resolve().parent.parent
N_DOCS = 100_000          # C = 2 chunks, the last one partial
N_TERMS = 12
SEED = 1402


@pytest.fixture(autouse=True)
def _clean_telemetry():
    obs.disable()
    obs.reset_metrics()
    obs.reset_traces()
    yield
    obs.disable()
    obs.reset_metrics()
    obs.reset_traces()


def _postings():
    rng = np.random.default_rng(SEED)
    out = {}
    for i in range(N_TERMS):
        size = max(4, int(0.4 * N_DOCS * (i + 1) ** -1.2))
        out[f"t{i:02d}"] = np.unique(rng.integers(0, N_DOCS, size))
    return out


def _queries(m):
    """Mixed shapes in both packages' query types (``m`` is a search
    module): AND/OR/ANDNOT, nesting, an unknown term, a duplicate leaf, and
    repeats of one shape so batches form."""
    t = m.term
    qs = [m.and_(t("t00"), t("t01")),
          m.or_(t("t03"), t("t07"), t("t11")),
          m.andnot(t("t00"), t("t04")),
          m.andnot(m.or_(t("t01"), t("t06")), m.and_(t("t00"), t("t02"))),
          m.and_(t("t00"), t("nope")),
          m.or_(t("t10"), t("t10"))]
    qs += [m.and_(t(f"t{i:02d}"), t(f"t{(i + 3) % N_TERMS:02d}"))
           for i in range(5)]
    return qs


def _np_eval(q, postings):
    """Brute-force boolean-array oracle (port query types)."""
    if isinstance(q, TS.Term):
        m = np.zeros(N_DOCS, bool)
        if q.term in postings:
            m[postings[q.term]] = True
        return m
    if isinstance(q, TS.AndNot):
        return _np_eval(q.a, postings) & ~_np_eval(q.b, postings)
    vals = [_np_eval(c, postings) for c in q.children]
    out = vals[0]
    for v in vals[1:]:
        out = (out & v) if isinstance(q, TS.And) else (out | v)
    return out


@pytest.fixture(scope="module")
def corpus():
    postings = _postings()
    jidx = JS.PostingIndex.from_postings(postings, N_DOCS)
    tidx = TS.PostingIndex.from_arrays(jidx.terms, slab_leaves(jidx.stack),
                                       N_DOCS, device="cpu")
    return jidx, tidx, postings


@pytest.fixture(scope="module")
def reference_answers(corpus):
    """The reference service's answers, computed once per mode."""
    jidx, _, _ = corpus
    svc = JS.SearchService(jidx, max_batch=4, cache_slots=16)
    qs = _queries(JS)
    return {"count": svc.search_many(qs, "count"),
            "docs": svc.search_many(qs, "docs"),
            "topk": svc.search_many(qs, "topk", k=5)}


def test_from_postings_builds_the_reference_bytes(corpus):
    """The port builds the reference's stack bytes; sharded over two gloo
    ranks, the built index answers top-k as the reference's does."""
    jidx, tidx, postings = corpus
    built = TS.PostingIndex.from_postings(postings, N_DOCS, device="cpu")
    assert built.terms == tidx.terms == jidx.terms
    for k, v in slab_leaves(jidx.stack).items():
        got = getattr(built.stack, k).numpy()
        assert np.array_equal(v, got.view(np.uint16) if k == "payload"
                              else got), k
    for t in ("t00", "t05", "nope"):
        assert built.posting(t).serialize() == jidx.posting(t).serialize()
    assert built.row("nope") == 0 and built.term_of(0) is None
    with pytest.raises(ValueError, match="outside"):
        TS.PostingIndex.from_postings({"a": np.array([0, 70000])}, 65536,
                                      device="cpu")
    check_two_rank_search()


PATHS = {"fused_batched": dict(fused=True, max_batch=4),
         "per_op_batched": dict(fused=False, max_batch=4),
         "fused_sequential": dict(fused=True, max_batch=1),
         "per_op_sequential": dict(fused=False, max_batch=1)}


def test_service_equals_reference_service(corpus, reference_answers):
    """Fused and per-op, batched and sequential: every mode answers as the
    reference service and the numpy oracle do."""
    _, tidx, postings = corpus
    qs = _queries(TS)
    for path in sorted(PATHS):
        for mode in ("count", "docs", "topk"):
            svc = TS.SearchService(tidx, cache_slots=16, **PATHS[path])
            got = svc.search_many(qs, mode, k=5)
            want = reference_answers[mode]
            if mode == "docs":
                for q, a, b in zip(qs, got, want):
                    assert np.array_equal(a, np.asarray(b)), (path, q)
                    assert np.array_equal(
                        a, np.nonzero(_np_eval(q, postings))[0]), (path, q)
            else:
                assert got == want, (path, mode)
            if mode == "count":
                assert got == [int(_np_eval(q, postings).sum()) for q in qs]


def test_cache_lru_and_backpressure(corpus):
    """A cache-warm rerun is identical and all hits; the LRU evicts in
    order within its capacity and counts exactly; the term budget defers
    what does not fit."""
    _check_cache_warm_rerun_is_identical(corpus)
    obs.reset_metrics()                 # the cache counters are global
    _check_lru_eviction_order_capacity_and_counters(corpus)
    _check_term_budget_backpressure_requeues(corpus)


def _check_cache_warm_rerun_is_identical(corpus):
    _, tidx, _ = corpus
    svc = TS.SearchService(tidx, max_batch=8, cache_slots=16)
    qs = _queries(TS)
    first = svc.search_many(qs, "docs")
    misses = svc.cache_stats()["misses"]
    again = svc.search_many(qs, "docs")
    for a, b in zip(first, again):
        assert np.array_equal(a, b)
    assert svc.cache_stats()["misses"] == misses        # all hits


def _check_lru_eviction_order_capacity_and_counters(corpus):
    _, tidx, _ = corpus
    svc = TS.SearchService(tidx, max_batch=1, cache_slots=3)
    t = TS.term
    svc.search(TS.and_(t("t00"), t("t01")))
    assert svc.cache_stats()["resident"] == ("t00", "t01")
    svc.search(t("t02"))
    svc.search(t("t00"))                     # hit refreshes recency
    assert svc.cache_stats()["resident"] == ("t01", "t02", "t00")
    svc.search(t("t03"))                     # evicts LRU = t01
    assert svc.cache_stats() == {"hits": 1, "misses": 4, "evictions": 1,
                                 "resident": ("t02", "t00", "t03")}
    with pytest.raises(ValueError, match="never be admitted"):
        svc.submit(TS.and_(t("t00"), t("t01"), t("t02"), t("t03")))


def _check_term_budget_backpressure_requeues(corpus):
    _, tidx, postings = corpus
    t = TS.term
    svc = TS.SearchService(tidx, max_batch=4, cache_slots=4)
    qs = [TS.and_(t("t00"), t("t01")), TS.and_(t("t02"), t("t03")),
          TS.and_(t("t04"), t("t05"))]
    rids = [svc.submit(q, "count") for q in qs]
    assert svc.step() == rids[:2] and svc.requeues == 1
    svc.run_until_done()
    for q, rid in zip(qs, rids):
        assert svc.take(rid) == int(_np_eval(q, postings).sum())


def test_ladder_drops_a_rung_only_for_injected_faults(corpus):
    """Faults injected on the "cuda" backend fire before any launch; on CPU
    tensors the ladder then lands on the plain-torch rung with the same
    answers. Any other error propagates without a fallback."""
    _, tidx, postings = corpus
    qs = _queries(TS)[:4]
    svc = TS.SearchService(tidx, max_batch=4, backend="cuda")
    with fault_scope(FaultPlan(every=1, backend="cuda")) as plan:
        got = svc.search_many(qs, "docs")
    for q, d in zip(qs, got):
        assert np.array_equal(d, np.nonzero(_np_eval(q, postings))[0])
    reg = obs.registry()
    assert plan.failures > 0
    assert reg.total("index.dispatch_failures") > 0
    assert reg.total("index.rung_taken", backend="torch") > 0
    assert reg.total("index.fallbacks") > 0

    obs.reset_metrics()
    svc = TS.SearchService(tidx, max_batch=4, backend="cuda")

    def hook(backend):
        raise RuntimeError("a real launch failure")

    from repro_torch.kernels.roaring import ops as TOPS
    prev = TOPS.set_fault_hook(hook)
    try:
        with pytest.raises(RuntimeError, match="real launch failure"):
            svc.search(TS.and_(TS.term("t00"), TS.term("t01")), "count")
    finally:
        TOPS.set_fault_hook(prev)
    assert obs.registry().total("index.fallbacks") == 0


def test_batched_launch_count_matches_model(corpus):
    _, tidx, _ = corpus
    t = TS.term
    qs = [TS.and_(t(f"t{i:02d}"), t(f"t{i + 1:02d}"), t(f"t{i + 2:02d}"))
          for i in range(4)]
    model = TS.SearchService(tidx).launch_model(qs[0])
    assert model["fused_launches"] == 1 and model["per_op_dispatches"] == 2
    obs.enable()
    for fused, entry, per_batch in ((True, "fused_tree", 1),
                                    (False, "intersect_dispatch", 2)):
        obs.reset_metrics()
        svc = TS.SearchService(tidx, max_batch=4, fused=fused)
        [svc.submit(q, "count") for q in qs]
        assert len(svc.step()) == 4
        assert obs.registry().total("roaring.launches", entry=entry) == \
            per_batch
    obs.reset_metrics()
    svc = TS.SearchService(tidx, max_batch=4)
    svc.search(qs[0], "topk", k=3)
    assert obs.registry().total("roaring.launches",
                                entry="intersect_dispatch_stacked") == 1
    names = {sp.name for sp in obs.span_trees()}
    assert {"search.plan", "search.cache", "search.execute"} <= names


def test_service_edges_and_loadgen(corpus):
    """Unknown terms, a bad mode, the default device; the load generator
    and its corpus law equal the reference's, and so does
    ``LoadStats.row_dict``."""
    _check_unknown_term_bad_mode_and_default_device(corpus)
    _check_loadgen_matches_reference(corpus)


def _check_unknown_term_bad_mode_and_default_device(corpus):
    _, tidx, postings = corpus
    svc = TS.SearchService(tidx)
    assert svc.search(TS.term("missing"), "count") == 0
    assert svc.search(TS.term("missing"), "docs").size == 0
    with pytest.raises(ValueError, match="mode"):
        svc.submit(TS.term("t00"), mode="explain")
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TS.PostingIndex.from_postings(postings, N_DOCS)


def _check_loadgen_matches_reference(corpus):
    from benchmarks.synth import gen_zipf_postings as j_gen
    for a, b in zip(j_gen(20, 50_000, 1.1, 7),
                    TS.gen_zipf_postings(20, 50_000, 1.1, 7)):
        assert np.array_equal(a, b)
    _, tidx, _ = corpus
    jq = JS.zipf_queries(tidx.terms, 6, 1.1, 3, terms_per_query=3, op="or")
    tq = TS.zipf_queries(tidx.terms, 6, 1.1, 3, terms_per_query=3, op="or")
    assert [[c.term for c in q.children] for q in jq] == \
        [[c.term for c in q.children] for q in tq]
    svc = TS.SearchService(tidx, max_batch=4, cache_slots=8)
    stats = TS.run_closed_loop(svc, tq, concurrency=4, mode="count")
    assert stats.n_requests == 6 and stats.qps > 0
    assert stats.p50_us <= stats.p99_us
    fields = {f: getattr(stats, f) for f in (
        "n_requests", "concurrency", "wall_s", "qps", "p50_us", "p99_us",
        "hit_rate", "latency")}
    assert stats.row_dict() == JS.LoadStats(**fields).row_dict()


# =============================================================================
# the import guard
# =============================================================================

def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]


def test_import_guard():
    """No module of the port, and not ``chip_smoke.py``, imports JAX or
    the reference package; the port imports with both blocked."""
    _check_no_jax_or_repro_import_statements()
    _check_imports_with_jax_and_repro_blocked()


def _check_no_jax_or_repro_import_statements():
    bad = []
    for f in _port_files():
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append((f.name, n))
    assert not bad, bad


def _check_imports_with_jax_and_repro_blocked():
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import repro_torch.search, repro_torch.index, repro_torch.obs\n"
        "import repro_torch.kernels.roaring.kernel\n"
        "import repro_torch.serve, repro_torch.launch.serve\n"
        "import repro_torch.models.convert, repro_torch.configs\n"
        "import repro_torch.kernels.sparse_attn.kernel\n"
        "import repro_torch.kernels.sparse_attn.ops\n"
        "import repro_torch.sparsity, repro_torch.optim, repro_torch.train\n"
        "import repro_torch.data, repro_torch.checkpoint\n"
        "import repro_torch.runtime, repro_torch.launch.train\n"
        "import repro_torch.roaring, repro_torch.roaring.validate\n"
        "import repro_torch.store, repro_torch.store.io\n"
        "import repro_torch.kernels.roaring.cases\n"
        "import repro_torch.baselines, repro_torch.distributed\n"
        "import repro_torch.grad_comp, repro_torch.models.flops\n"
        "assert not any(m.split('.')[0] in ('jax', 'repro') "
        "for m in sys.modules)\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin"}, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
