"""Port parity: the Roaring object API and the bitmap-index store.

Two test items (the tier-1 memory-map budget holds the suite to 383
collected tests; see ROADMAP queue 3). Against the reference package, on
the CPU, with inputs made from a seed with numpy; Roaring results compare
as ``serialize()`` bytes (values, cards, kinds and payload), counts and
values exactly:

* the object API: the constructors (``empty``, ``from_values``,
  ``from_indices``, ``from_ranges``, ``from_roaring(check=)``,
  ``deserialize`` and ``RoaringFormatSpec._deserialize_trusted`` of the
  golden corpus), every operator and method (``&``,
  ``|``, ``^``, ``-``, ``and_card``, ``or_card``, ``jaccard``,
  ``contains``, ``rank``, ``select``, ``run_optimize``, ``n_containers``,
  ``size_in_bytes``, ``to_dense``, ``to_indices``) on single and stacked
  slabs, ``stack`` / ``union_all`` / ``intersect_all`` (with the capacity
  applied after alignment), the engine's ``wide_union`` /
  ``wide_intersect``, the invariant auditor's reports on the regression
  corpus and on broken slabs. Each reference call is eager and costs
  seconds, so ``&``, ``-``, ``intersect_all(capacity=)``, ``stack``, the
  constructors, the cardinalities and the access operations are held
  against the reference object API, and everything (those included)
  against the ``py_roaring`` oracle, which the reference's own tests hold
  equal to its object API byte for byte;
* the store: a census-like store built by both packages from the same
  records saves the same bytes; the golden store corpus loads and re-saves
  byte-identically; predicates (eq, in, range on eq and bit-sliced
  columns, or, not) give the reference store's bytes and the numpy row
  filter's, fused and per-op, ``count`` and ``sum_`` equal; typed load
  rejections; only an injected fault takes the plan cache's fallback;
  ``PostingIndex.from_store``.

The reference side stays small: each of its trees pays an XLA compile.
"""

import dataclasses
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import release_jax_executables, to_np16  # noqa: F401
from repro import index as JIX
from repro import roaring as JRG
from repro import store as JST
from repro.core import py_roaring as jpr
from repro_torch import index as TIX
from repro_torch import roaring as TRG
from repro_torch import search as TSE
from repro_torch import store as TST
from repro_torch.core import py_roaring as tpr

SEED = 1402
CORPUS = Path(__file__).resolve().parent / "corpus"
LEAVES = ("keys", "kinds", "cards", "nruns")


def _same_leaves(js, ts, what=""):
    for k in LEAVES:
        assert np.array_equal(np.asarray(getattr(js, k)),
                              getattr(ts, k).numpy()), (what, k)
    assert np.array_equal(np.asarray(js.payload), to_np16(ts.payload)), what


def _sets(rng, n):
    """``n`` value sets over 4 chunks mixing every container kind: sparse
    arrays, dense bitmaps, runs (one to 65,535), the 4096 boundary."""
    out = []
    for i in range(n):
        parts = [rng.integers(0, 4 << 16, 300 + 100 * i),
                 (1 << 16) + rng.choice(1 << 16, 4096 - i, replace=False),
                 np.arange((2 << 16) + 1000 * i, (2 << 16) + 9000),
                 np.arange((3 << 16) - 40 + 7 * i, 3 << 16),
                 (3 << 16) + rng.integers(0, 1 << 16, 9000 + 500 * i)]
        keep = [p for j, p in enumerate(parts) if (i + j) % 4 != 3]
        out.append(np.unique(np.concatenate(keep)).astype(np.int64))
    return out


def _pair(vals, capacity=4):
    jb = jpr.RoaringBitmap.from_sorted_unique(vals).run_optimize()
    tb = tpr.RoaringBitmap.from_sorted_unique(vals).run_optimize()
    return (JRG.RoaringSlab.from_roaring(jb, capacity),
            TRG.RoaringSlab.from_roaring(tb, capacity, device="cpu"))


# =============================================================================
# the object API
# =============================================================================

def test_object_api_equals_reference():
    warnings.simplefilter("ignore", DeprecationWarning)
    rng = np.random.default_rng(SEED)
    sets = _sets(rng, 3)
    js, ts = zip(*[_pair(v) for v in sets])
    _check_constructors(rng, sets)
    _check_pairwise(js, ts)
    _check_access(js[0], ts[0], sets[0])
    _check_stacked_and_wide(js, ts)
    _check_against_host_oracle(rng)
    _check_slab_functions(ts)
    _check_auditor(ts[0])


def _check_constructors(rng, sets):
    vals = sets[1]
    jv = JRG.RoaringSlab.from_values(vals, 4, vals.size + 5)
    tv = TRG.RoaringSlab.from_values(vals, 4, vals.size + 5, device="cpu")
    _same_leaves(jv, tv, "from_values")
    idx = np.sort(rng.choice(1 << 18, 5000, replace=False))
    valid = np.arange(idx.size) < 4800
    ti = TRG.RoaringSlab.from_indices(torch.from_numpy(idx),
                                      torch.from_numpy(valid), 3)
    _same_leaves(JRG.RoaringSlab.from_indices(
        jnp.asarray(idx), jnp.asarray(valid), 3), ti, "from_indices")
    ranges = [(5, 70000), (131000, 131100), (200000, 262144)]
    _same_leaves(JRG.RoaringSlab.from_ranges(ranges, 5),
                 TRG.RoaringSlab.from_ranges(ranges, 5, device="cpu"),
                 "from_ranges")
    _same_leaves(JRG.RoaringSlab.empty(3),
                 TRG.RoaringSlab.empty(3, device="cpu"), "empty")
    goldens = sorted(p for p in CORPUS.glob("golden_*.bin")
                     if not p.name.startswith("golden_store"))
    assert len(goldens) == 5
    for path in goldens:
        data = path.read_bytes()
        t = TRG.RoaringSlab.deserialize(data, check=True, device="cpu")
        _same_leaves(JRG.RoaringSlab.deserialize(data), t, path.name)
        assert t.serialize() == data, path.name
        # the trusted-input decode loop gives the reference's bitmap
        jt = JRG.RoaringFormatSpec._deserialize_trusted(data)
        tt = TRG.RoaringFormatSpec._deserialize_trusted(data)
        assert tt.keys == jt.keys, path.name
        assert TRG.RoaringFormatSpec.serialize(tt) == \
            JRG.RoaringFormatSpec.serialize(jt) == data, path.name
    with pytest.raises(TRG.RoaringFormatError):
        TRG.RoaringSlab.deserialize(goldens[0].read_bytes(), capacity=0,
                                    device="cpu")


def _check_pairwise(js, ts):
    (ja, jb, _), (ta, tb, tc) = js, ts
    for op in ("__and__", "__sub__"):
        assert getattr(ta, op)(tb).serialize() == \
            getattr(ja, op)(jb).serialize(), op
    for fn in ("and_card", "or_card"):
        assert int(getattr(ta, fn)(tb)) == int(getattr(ja, fn)(jb)), fn
    got, want = ta.jaccard(tb), ja.jaccard(jb)
    assert got.dtype == torch.float32 and float(got) == float(want)
    assert float(TRG.RoaringSlab.empty(2, device="cpu").jaccard(
        TRG.RoaringSlab.empty(2, device="cpu"))) == 0.0
    for x, y in ((ta, tb), (tc, ta), (tb, tc)):
        _check_ops_against_oracle(x, y)
    assert ta.or_(tb, capacity=6).C == 6
    assert ta.or_(tb, capacity=6).serialize() == (ta | tb).serialize()


def _oracle(s):
    return s.to_roaring()


def _bytes(rb):
    return TRG.RoaringFormatSpec.serialize(rb.run_optimize())


def _check_ops_against_oracle(x, y):
    rx, ry = _oracle(x), _oracle(y)
    for got, want in ((x & y, rx & ry), (x | y, rx | ry), (x ^ y, rx ^ ry),
                      (x - y, rx.andnot(ry))):
        assert got.serialize() == _bytes(want)
    assert int(x.and_card(y)) == len(rx & ry)
    assert int(x.or_card(y)) == len(rx | ry)


def _check_access(ja, ta, vals):
    q = np.array([0, int(vals[0]), int(vals[-1]), 65535, 65536, 131071,
                  131072 + 1500, (3 << 16) - 1, 3 << 16, 1 << 20, -1],
                 np.int64)
    got = ta.contains(torch.from_numpy(q)).numpy()
    assert np.array_equal(got, np.asarray(ja.contains(jnp.asarray(q))))
    assert np.array_equal(got, np.isin(q, vals))
    xs = np.array([0, vals[500], 131071, (3 << 16) + 20000, 1 << 20])
    assert np.array_equal(ta.rank(torch.from_numpy(xs)).numpy(),
                          np.searchsorted(vals, xs, side="right"))
    js = np.array([0, 1, 777, vals.size // 2, vals.size - 1, vals.size, -1])
    got = ta.select(torch.from_numpy(js)).numpy()
    assert np.array_equal(got, [int(vals[j]) if 0 <= j < vals.size else -1
                                for j in js.tolist()])
    assert int(got[2]) == int(ja.select(jnp.asarray(777)))
    assert int(ta.n_containers()) == int(ja.n_containers())
    assert int(ta.size_in_bytes()) == int(ja.size_in_bytes()) == \
        ta.to_roaring().size_in_bytes()
    # a non-canonical slab (every container an array or bitmap)
    plain = TRG.RoaringSlab.from_roaring(
        tpr.RoaringBitmap.from_sorted_unique(vals), 4, device="cpu")
    assert plain.run_optimize().serialize() == ta.serialize()
    assert np.array_equal(np.nonzero(ta.to_dense())[0], vals)
    idx, valid = ta.to_indices(vals.size + 3)
    assert np.array_equal(idx[valid].numpy(), vals)
    assert not valid[vals.size:].any() and not idx[vals.size:].any()


def _check_stacked_and_wide(js, ts):
    jst, tst = JRG.stack(list(js)), TRG.stack(list(ts))
    _same_leaves(jst, tst, "stack")
    assert tst.n_slabs == 3 and tst[1].ndim == 1
    raw = TRG.stack(list(ts), align=False)
    assert raw.ndim == 2 and raw.C == 4
    anded = raw & ts[0]                              # broadcast member
    for i in range(3):
        assert anded[i].serialize() == (ts[i] & ts[0]).serialize(), i
    assert np.array_equal(raw.and_card(raw).numpy(), raw.card().numpy())
    assert np.array_equal(raw.contains(torch.tensor([131073])).numpy()[:, 0],
                          [t.contains(torch.tensor([131073]))[0]
                           for t in ts])
    rbs = [_oracle(t) for t in ts]
    union = TRG.union_all(list(ts))
    assert union.serialize() == _bytes(rbs[0] | rbs[1] | rbs[2])
    assert TIX.wide_union(tst).serialize() == union.serialize()
    inter = TRG.intersect_all(list(ts))
    assert inter.serialize() == _bytes(rbs[0] & rbs[1] & rbs[2])
    assert TIX.wide_intersect(tst).serialize() == inter.serialize()
    cut_t, cut_j = (m.intersect_all(list(s[:2]), capacity=1)
                    for m, s in ((TRG, ts), (JRG, js)))
    assert cut_t.C == 1 and cut_t.serialize() == cut_j.serialize()
    batched = TRG.union_all([raw, raw], capacity=4)
    for i in range(3):
        assert batched[i].serialize() == ts[i].serialize(), i


def _check_against_host_oracle(rng):
    """More pairs, port only, against the port's own ``py_roaring``."""
    for _ in range(3):
        x, y = (TRG.RoaringSlab.from_roaring(
            tpr.RoaringBitmap.from_sorted_unique(v).run_optimize(), 4,
            device="cpu") for v in _sets(rng, 2))
        _check_ops_against_oracle(x, y)


def _check_slab_functions(ts):
    """The engine's free functions the object API does not reach: the
    bitmap-domain baselines (array / bitmap kinds only), the N-member
    forms, ``extract_row`` and the deprecated batched union."""
    from repro_torch.core import torch_roaring as tr
    from repro_torch.roaring.slab import _to_internal
    a, b = _to_internal(ts[0]), _to_internal(ts[1])
    ra, rb = _oracle(ts[0]), _oracle(ts[1])
    for got, want in ((tr.slab_and_bitmap_domain(a, b), ra & rb),
                      (tr.slab_or_bitmap_domain(a, b), ra | rb)):
        idx, valid = tr.to_indices(got)
        assert np.array_equal(idx[valid].numpy(), want.to_array())
        assert set(got.kind.tolist()) <= {0, 1, 2}
    many = tr.slab_and_many(a, [a, b])
    assert many.keys.shape == (2, 4)
    assert np.array_equal(tr.slab_and_card_many(a, [a, b]).numpy(),
                          [len(ra), len(ra & rb)])
    vals, valid = tr.extract_row(a, 0)
    assert np.array_equal(vals[valid].numpy(), ra.containers[0].to_array())
    with pytest.warns(DeprecationWarning):
        out = TIX.union_many_batched(list(ts), capacity=8)
    assert out.serialize() == TRG.union_all(list(ts)).serialize()


def _check_auditor(ta):
    from repro.roaring import validate as JV
    assert TRG.audit_slab(ta, canonical=True).ok
    for path in sorted((CORPUS / "regressions").glob("*.bin")):
        data = path.read_bytes()
        outcome = []
        for codec in (JRG.RoaringFormatSpec, TRG.RoaringFormatSpec):
            try:
                codec.deserialize(data, check=True)
                outcome.append(None)
            except Exception as e:                      # typed rejection
                outcome.append((type(e).__name__, str(e)))
        assert outcome[0] == outcome[1] and outcome[1] is not None, \
            path.name
    # broken slabs: the same violation codes, member by member
    bad = TRG.stack([ta, ta], align=False)
    bad.cards[1, 1] += 1                               # bitmap popcount
    bad.payload[0, 0, 3] = bad.payload[0, 0, 2]        # array out of order
    jbad = JRG.RoaringSlab(keys=jnp.asarray(bad.keys.numpy()),
                           kinds=jnp.asarray(bad.kinds.numpy()),
                           cards=jnp.asarray(bad.cards.numpy()),
                           nruns=jnp.asarray(bad.nruns.numpy()),
                           payload=jnp.asarray(to_np16(bad.payload)), C=4)
    got, want = TRG.audit_slab(bad), JV.audit_slab(jbad)
    assert [(v.code, v.container, v.member) for v in got.violations] == \
        [(v.code, v.container, v.member) for v in want.violations]
    assert {v.code for v in got.violations} >= {"card-mismatch",
                                                "array-order"}
    with pytest.raises(TRG.InvariantViolation):
        TRG.RoaringSlab.from_roaring(bad[0].to_roaring(), 4, check=True,
                                     device="cpu")


# =============================================================================
# the store
# =============================================================================

def _census_records(n_rows=1500, seed=1):
    """The reference's census-like test workload, small: correlated
    low-cardinality categorical columns, two integer columns (capped to 5 /
    4 bits) and a string column."""
    rng = np.random.default_rng(seed)
    latent = rng.integers(0, 8, n_rows)
    records = {}
    for i in range(4):
        card = (2, 8, 16, 32)[i]
        noise = rng.integers(0, max(2, card // 4), n_rows)
        records[f"cat{i}"] = ((latent * (card // 8 + 1) + noise) % card
                              ).astype(np.int64)
    records["int0"] = np.clip(rng.normal(30 + 5 * latent, 12, n_rows), 0,
                              95).astype(np.int64) % 28
    records["int1"] = np.minimum(rng.lognormal(9 + 0.15 * latent, 0.7,
                                               n_rows),
                                 500_000).astype(np.int64) % 13
    names = np.asarray(["east", "west", "north", "south"])
    records["region"] = names[records["cat2"] % 4]
    return records


def _oracle_mask(records, n_rows, pred):
    """Evaluate a predicate directly over the raw columns."""
    if isinstance(pred, TST.Eq):
        return np.asarray(records[pred.col]) == pred.value
    if isinstance(pred, TST.In):
        return np.isin(np.asarray(records[pred.col]), list(pred.values))
    if isinstance(pred, TST.Range):
        arr = np.asarray(records[pred.col])
        lo = -np.inf if pred.lo is None else pred.lo
        hi = np.inf if pred.hi is None else pred.hi
        return (arr >= lo) & (arr <= hi)
    if isinstance(pred, TST.AndP):
        return np.logical_and.reduce(
            [_oracle_mask(records, n_rows, c) for c in pred.children])
    if isinstance(pred, TST.OrP):
        return np.logical_or.reduce(
            [_oracle_mask(records, n_rows, c) for c in pred.children])
    if isinstance(pred, TST.NotP):
        return ~_oracle_mask(records, n_rows, pred.child)
    raise TypeError(pred)


def _preds(m):
    """The same predicates in either package's predicate language."""
    return [
        m.eq("cat0", 0),
        m.in_("cat1", [1, 3, 99]),
        m.and_(m.eq("region", "east"), m.range_("int0", 5, 20)),
        m.or_(m.range_("cat3", 4, 9), m.not_(m.range_("int1", None, 6))),
        m.and_(m.not_(m.eq("cat2", 5)), m.range_("int0", 12, None),
               m.in_("region", ["west", "north"])),
    ]


# (predicate index, fused) pairs also run on the reference store
REF_RUNS = ((0, False), (2, True), (3, True))


def test_store_equals_reference_and_oracle():
    records = _census_records()
    js = JST.BitmapStore.build(records, bsi=("int0", "int1"))
    ts = TST.BitmapStore.build(records, bsi=("int0", "int1"), device="cpu")
    blob = ts.save()
    assert blob == js.save()
    assert ts.n_slabs == js.n_slabs and repr(ts) == repr(js)
    assert ts.index_size_in_bytes() == js.index_size_in_bytes()
    for name in ("cat1", "int0", "region"):
        assert dataclasses.asdict(ts.column(name)) == dataclasses.asdict(
            js.column(name))
    again = TST.BitmapStore.load(blob, check=True, device="cpu")
    assert again.save() == blob
    for path in sorted(CORPUS.glob("golden_store_*.bin")):
        data = path.read_bytes()
        assert TST.BitmapStore.load(data, check=True,
                                    device="cpu").save() == data, path.name
    tp, jp = _preds(TST), _preds(JST)
    for i, pred in enumerate(tp):
        ids = np.nonzero(_oracle_mask(records, ts.n_rows, pred))[0]
        want = TRG.RoaringFormatSpec.serialize(
            tpr.RoaringBitmap.from_sorted_unique(ids).run_optimize())
        for fused in (False, True):
            assert ts.query(pred, fused=fused).serialize() == want, (i, fused)
            assert ts.count(pred, fused=fused) == ids.size, (i, fused)
        assert np.array_equal(ts.query_indices(pred), ids)
        assert ts.sum_("int0", pred) == int(records["int0"][ids].sum())
    for i, fused in REF_RUNS:
        assert ts.query(tp[i], fused=fused).serialize() == js.query(
            jp[i], fused=fused).serialize(), (i, fused)
        assert ts.count(tp[i], fused=fused) == js.count(jp[i], fused=fused)
    assert ts.sum_("int1", tp[0]) == js.sum_("int1", jp[0])
    assert ts.sum_("int1") == js.sum_("int1") == int(records["int1"].sum())
    stats = ts.cache_stats()
    assert stats["misses"] == stats["entries"] and stats["hits"] > 0
    # a kept plan holds the stack's key row and no copy of operand rows
    for plan in ts._plans.values():
        held = [getattr(plan, f.name) for f in dataclasses.fields(plan)]
        held = [t for t in held if isinstance(t, torch.Tensor)]
        assert [t.shape for t in held] == [(ts.n_chunks,)]
    assert stats["fallbacks"] == 0 and stats["keyed_by"] == \
        js.cache_stats()["keyed_by"]
    _check_store_rejections(blob)
    _check_faults_and_device(ts, tp[2])
    _check_from_store(ts, records)


def _check_faults_and_device(ts, pred):
    """Only an injected fault takes the uncompiled fallback (and it is
    counted); any other error propagates; no device means the card."""
    from repro_torch.kernels.roaring import ops as TOPS
    from repro_torch.runtime.fault_tolerance import InjectedFault

    def fail(exc):
        def hook(backend):
            raise exc
        return hook

    before = ts.cache_stats()["fallbacks"]
    prev = TOPS.set_fault_hook(fail(RuntimeError("launch failed")))
    try:
        with pytest.raises(RuntimeError, match="launch failed"):
            ts.count(pred, fused=True)
        assert ts.cache_stats()["fallbacks"] == before
        TOPS.set_fault_hook(fail(InjectedFault("injected")))
        with pytest.raises(InjectedFault):
            ts.count(pred, fused=True)
        assert ts.cache_stats()["fallbacks"] == before + 1
    finally:
        TOPS.set_fault_hook(prev)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TST.BitmapStore.build({"a": np.arange(3)})


def _rejection(load, data):
    try:
        load(data)
    except Exception as e:                              # typed rejection
        return type(e).__name__, str(e)
    return None


def _check_store_rejections(blob):
    meta_len = int.from_bytes(blob[8:12], "little")
    bad = [blob[:5], b"NOTSTORE" + blob[8:], blob + b"\x00", blob[:-3],
           blob[:12] + blob[12:12 + meta_len].replace(b'"n_rows":1500',
                                                      b'"n_rows": 1500')
           + blob[12 + meta_len:]]
    for data in bad:
        got = _rejection(lambda d: TST.BitmapStore.load(d, device="cpu"),
                         data)
        assert got is not None and got == _rejection(JST.BitmapStore.load,
                                                      data)
    # the slabs x chunks cap: the default refuses, a raised cap loads
    big = TST.BitmapStore.build({"v": np.arange(70000) % 3}, device="cpu")
    data = big.save()
    with pytest.raises(TST.StoreFormatError, match="cells"):
        TST.BitmapStore.load(data, max_stack_cells=9, device="cpu")
    assert TST.BitmapStore.load(data, max_stack_cells=10,
                                device="cpu").save() == data


def _check_from_store(ts, records):
    index = TSE.PostingIndex.from_store(ts, "cat1")
    values = sorted(set(records["cat1"].tolist()))
    assert index.terms == tuple(sorted(f"cat1={v}" for v in values))
    for v in values[:3]:
        got = index.posting(f"cat1={v}").to_roaring().to_array()
        assert np.array_equal(got, np.nonzero(records["cat1"] == v)[0])
    with pytest.raises(TypeError):
        TSE.PostingIndex.from_store(ts, "int0")
