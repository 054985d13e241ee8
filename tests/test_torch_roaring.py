"""Port parity: the row-state algebra, canonicalization, the slab object,
the codec and the query engine, and the paper's RLE baselines (WAH,
Concise, BitSet; ``_torch_baselines.check_baselines``, inside the codec
item).

Seeded inputs go through the reference (``repro``, XLA on the CPU) and the
port (``repro_torch``, plain torch on the CPU); row states are compared
exactly as integers (keys, cards, kinds, every payload word) and results as
``serialize()`` bytes.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _hypothesis_compat import given, settings, st
from _torch_baselines import check_baselines
from _torch_parity import (KIND_CASES, container_row,  # noqa: F401
                           release_jax_executables, slab_leaves, to_np16,
                           to_t16)
from repro import index as JIX
from repro import roaring as JRG
from repro.core import jax_roaring as jr
from repro.core import py_roaring as jpr
from repro_torch import index as TIX
from repro_torch.core import py_roaring as tpr
from repro_torch.core import torch_roaring as tr
from repro_torch.roaring import RoaringFormatSpec, RoaringSlab

SEED = 1402
CORPUS = Path(__file__).resolve().parent / "corpus"


def _row_states(seed, M=24):
    """M rows of every kind with random (mostly non-canonical) forms: the
    bitmaps and runs below canonicalize to arrays, runs and bitmaps."""
    rng = np.random.default_rng(seed)
    pool = [container_row(KIND_CASES[n][1](rng)) for n in sorted(KIND_CASES)]
    sparse = np.unique(rng.integers(0, 1 << 16, 200))
    bits = np.zeros(1 << 16, bool)
    bits[sparse] = True
    pool.append((2, sparse.size, 0,                  # bitmap -> array
                 np.packbits(bits, bitorder="little").view(np.uint16)))
    bits = np.zeros(1 << 16, bool)
    bits[1000:9000] = True
    bits[65000:] = True
    pool.append((2, int(bits.sum()), 0,              # bitmap -> run (to 65535)
                 np.packbits(bits, bitorder="little").view(np.uint16)))
    row = np.full(4096, 0xFFFF, np.uint16)
    row[0:600:2] = np.arange(300) * 200
    row[1:600:2] = 0
    pool.append((3, 300, 300, row))                  # run -> array
    pool.append(container_row([]))
    kind = np.zeros(M, np.int32)
    card = np.zeros(M, np.int32)
    data = np.zeros((M, 4096), np.uint16)
    for i in range(M):
        kind[i], card[i], _, data[i] = pool[rng.integers(len(pool))]
    keys = np.sort(rng.choice(1000, M, replace=False)).astype(np.int32)
    return keys, data, card, kind


def _np_state(t):
    return tuple(np.asarray(x) for x in t)


def _t_state(keys, data, card, kind):
    return (torch.from_numpy(keys), to_t16(data), torch.from_numpy(card),
            torch.from_numpy(kind))


def _same_slab(js, ts):
    """Reference internal slab == port internal slab, field by field."""
    assert np.array_equal(np.asarray(js.keys), ts.keys.numpy())
    assert np.array_equal(np.asarray(js.card), ts.card.numpy())
    assert np.array_equal(np.asarray(js.kind), ts.kind.numpy())
    assert np.array_equal(np.asarray(js.data), to_np16(ts.data))


def _check_finalize_rows_bytes():
    for seed in (0, 1, 2):
        keys, data, card, kind = _row_states(seed)
        js = jr._finalize_rows(jnp.asarray(keys), jnp.asarray(data),
                               jnp.asarray(card), jnp.asarray(kind))
        ts = tr._finalize_rows(*_t_state(keys, data, card, kind))
        _same_slab(js, ts)
        want = JRG.RoaringFormatSpec.serialize(jr.to_roaring(js))
        assert RoaringFormatSpec.serialize(tr.to_roaring(ts)) == want, seed


def test_row_algebra_equals_reference():
    """The canonicalization (``_finalize_rows``, field by field and as
    bytes), the combine steps, the deferred OR with its recount, the run
    counts and the row conversions."""
    _check_finalize_rows_bytes()
    for op in ("and", "or", "andnot"):
        _check_combine_step(op)
    _check_deferred_or_and_recount()
    _check_rows_nruns_and_conversions()


def _check_combine_step(op):
    _, da, ca, ka = _row_states(10)
    _, db, cb, kb = _row_states(11)
    jf = {"and": jr._and_rows, "or": jr._or_rows,
          "andnot": jr._andnot_rows}[op]
    tf = {"and": tr._and_rows, "or": tr._or_rows,
          "andnot": tr._andnot_rows}[op]
    jd, jc, jk = _np_state(jf(jnp.asarray(da), jnp.asarray(ca),
                              jnp.asarray(ka), jnp.asarray(db),
                              jnp.asarray(cb), jnp.asarray(kb)))
    td, tc, tk = tf(to_t16(da), torch.from_numpy(ca), torch.from_numpy(ka),
                    to_t16(db), torch.from_numpy(cb), torch.from_numpy(kb))
    assert np.array_equal(jc, tc.numpy())
    assert np.array_equal(jk, tk.numpy())
    assert np.array_equal(jd, to_np16(td))


def _check_deferred_or_and_recount():
    _, da, ca, ka = _row_states(12)
    _, db, cb, kb = _row_states(13)
    j = jr._or_rows_deferred(*(jnp.asarray(x) for x in (da, ca, ka, db, cb,
                                                         kb)))
    t = tr._or_rows_deferred(to_t16(da), torch.from_numpy(ca),
                             torch.from_numpy(ka), to_t16(db),
                             torch.from_numpy(cb), torch.from_numpy(kb))
    assert np.array_equal(np.asarray(j[1]), t[1].numpy())
    jc = jr._recount_bitmap_rows(*j)
    tc = tr._recount_bitmap_rows(*t)
    assert np.array_equal(np.asarray(jc), tc.numpy())


def _check_rows_nruns_and_conversions():
    keys, data, card, kind = _row_states(14)
    assert np.array_equal(
        np.asarray(jr._rows_nruns(jnp.asarray(data), jnp.asarray(kind))),
        tr._rows_nruns(to_t16(data), torch.from_numpy(kind)).numpy())
    bits = np.asarray(jr._lift_rows(jnp.asarray(data), jnp.asarray(card),
                                    jnp.asarray(kind)))
    tbits = tr._lift_rows(to_t16(data), torch.from_numpy(card),
                          torch.from_numpy(kind))
    assert np.array_equal(bits, tbits.numpy())
    jb = jnp.asarray(bits)
    assert np.array_equal(np.asarray(jax.vmap(jr.row_nruns_bits)(jb)),
                          tr.row_nruns_bits(tbits).numpy())
    assert np.array_equal(np.asarray(jax.vmap(jr._row_runs_from_bits)(jb)),
                          tr._row_runs_from_bits(tbits).numpy())


# =============================================================================
# slab object, codec
# =============================================================================

def _oracle_bitmaps(seed, n=6):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        parts = [(k << 16) + KIND_CASES[name][1](rng)
                 for k, name in enumerate(sorted(KIND_CASES))
                 if rng.random() < 0.6]
        vals = np.unique(np.concatenate(parts)) if parts else np.zeros(0)
        out.append(vals.astype(np.int64))
    return out


def test_slab_and_codec_equal_reference():
    """``from_roaring`` and ``from_numpy`` give the reference's leaves and
    serialized bytes; the golden corpus replays byte-exact through the
    port's codec; no device means the card. The baselines the paper sizes
    Roaring against equal the reference's word for word."""
    check_baselines()
    _check_from_roaring_serialize()
    _check_from_numpy_carries_reference_bytes()
    goldens = sorted(p for p in CORPUS.glob("golden_*.bin")
                     if not p.name.startswith("golden_store"))
    assert len(goldens) == 5
    for path in goldens:
        data = path.read_bytes()
        rb = RoaringFormatSpec.deserialize(data)
        assert RoaringFormatSpec.serialize(rb) == data, path.name
        assert JRG.RoaringFormatSpec.serialize(
            JRG.RoaringFormatSpec.deserialize(data)) == data, path.name
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            RoaringSlab.from_roaring(tpr.RoaringBitmap(), 1)


def _check_from_roaring_serialize():
    for vals in _oracle_bitmaps(SEED):
        jb = jpr.RoaringBitmap.from_sorted_unique(vals).run_optimize()
        tb = tpr.RoaringBitmap.from_sorted_unique(vals).run_optimize()
        js = JRG.RoaringSlab.from_roaring(jb, 12)
        ts = RoaringSlab.from_roaring(tb, 12, device="cpu")
        assert ts.serialize() == js.serialize()
        for k in ("keys", "kinds", "cards", "nruns"):
            assert np.array_equal(np.asarray(getattr(js, k)),
                                  getattr(ts, k).numpy()), k
        assert np.array_equal(np.asarray(js.payload), to_np16(ts.payload))
        idx, valid = ts.to_indices()
        assert np.array_equal(idx[valid].numpy(), vals)
        assert int(ts.card()) == vals.size


def _check_from_numpy_carries_reference_bytes():
    vals = _oracle_bitmaps(SEED + 1, n=1)[0]
    js = JRG.RoaringSlab.from_roaring(
        jpr.RoaringBitmap.from_sorted_unique(vals).run_optimize(), 10)
    ts = RoaringSlab.from_numpy(**slab_leaves(js), device="cpu")
    assert ts.C == 10 and ts.ndim == 1
    assert ts.serialize() == js.serialize()
    with pytest.raises(ValueError, match="payload"):
        RoaringSlab.from_numpy(js.keys, js.kinds, js.cards, js.nruns,
                               np.zeros((3, 4096), np.uint16), device="cpu")


# =============================================================================
# the engine: per-op and fused execute over a stack carried across
# =============================================================================

@pytest.fixture(scope="module")
def stacks():
    bms = _oracle_bitmaps(SEED + 2, n=5)
    jslabs = [JRG.RoaringSlab.from_roaring(
        jpr.RoaringBitmap.from_sorted_unique(v).run_optimize(), 8)
        for v in bms]
    jstack = JRG.stack(jslabs, capacity=8)
    tstack = RoaringSlab.from_numpy(**slab_leaves(jstack), device="cpu")
    return jstack, tstack


EXPRS = {
    "and3": ("and", 0, 1, 2),
    "or4": ("or", 0, 1, 3, 4),
    "andnot": ("andnot", 0, 3),
    "mixed": ("andnot", ("or", 0, 1, 2), ("and", 3, 4, 1)),
}


def _build(mod, tree):
    if isinstance(tree, int):
        return mod.leaf(tree)
    kids = [_build(mod, c) for c in tree[1:]]
    return {"and": mod.and_, "or": mod.or_,
            "andnot": lambda a, b: mod.andnot(a, b)}[tree[0]](*kids)


def test_execute_equals_reference_and_host_oracle(stacks):
    """The reference's fused result (its own tests hold it equal to its
    per-op path) == the port's per-op and fused results as bytes, and the
    fused payload word for word; every tree, per-op and fused, equals the
    host oracle in bytes and card; ``topk_by_card`` equals the reference's,
    ties included."""
    jstack, tstack = stacks
    je = _build(JIX, EXPRS["mixed"])
    te = _build(TIX, EXPRS["mixed"])
    jo = JIX.execute(jstack, je, fused=True)
    for fused in (False, True):
        to = TIX.execute(tstack, te, fused=fused)
        assert to.serialize() == jo.serialize()
    # dead rows' payload fill is path-specific; the fused paths match word
    # for word
    assert np.array_equal(np.asarray(jo.payload), to_np16(to.payload))
    assert TIX.launch_model(te) == JIX.launch_model(je)
    for name in sorted(EXPRS):
        for fused in (False, True):
            _check_execute_against_host_oracle(tstack, name, fused)
    _check_topk_by_card_with_ties(jstack, tstack)


def _oracle_eval(tree, bms):
    if isinstance(tree, int):
        return bms[tree]
    vals = [_oracle_eval(c, bms) for c in tree[1:]]
    if tree[0] == "andnot":
        return vals[0].andnot(vals[1])
    out = vals[0]
    for v in vals[1:]:
        out = (out & v) if tree[0] == "and" else (out | v)
    return out


def _check_execute_against_host_oracle(tstack, name, fused):
    bms = [tstack[i].to_roaring() for i in range(tstack.n_slabs)]
    want = _oracle_eval(EXPRS[name], bms)
    te = _build(TIX, EXPRS[name])
    got = TIX.execute(tstack, te, fused=fused)
    assert got.serialize() == RoaringFormatSpec.serialize(want), name
    assert int(TIX.execute_card(tstack, te, fused=fused)) == len(want), name


def _check_topk_by_card_with_ties(jstack, tstack):
    for q in range(5):
        js, ji = JIX.topk_by_card(jstack, jstack[q], 5)
        ts, ti = TIX.topk_by_card(tstack, tstack[q], 5)
        assert np.array_equal(np.asarray(js), ts.numpy())
        assert np.array_equal(np.asarray(ji), ti.numpy())
    jq = JRG.RoaringSlab.empty(8)           # every score 0: order by index
    tq = RoaringSlab.from_numpy(**slab_leaves(jq), device="cpu")
    assert np.array_equal(np.asarray(JIX.topk_by_card(jstack, jq, 5)[1]),
                          TIX.topk_by_card(tstack, tq, 5)[1].numpy())


@settings(max_examples=12, deadline=None)
@given(st.lists(st.sets(st.integers(0, (3 << 16) - 1), max_size=300),
                min_size=2, max_size=4))
def test_slab_leaf_execute_matches_host_oracle(sets):
    """Random small sets through ``leaf(slab)`` trees on the port alone,
    held against the port's host oracle as serialized bytes."""
    bms = [tpr.RoaringBitmap.from_array(sorted(s)).run_optimize()
           for s in sets]
    slabs = [RoaringSlab.from_roaring(b, 4, device="cpu") for b in bms]
    leaves = [TIX.leaf(s) for s in slabs]
    got = TIX.execute(TIX.andnot(TIX.or_(*leaves[1:]), leaves[0]))
    want = bms[1]
    for b in bms[2:]:
        want = want | b
    want = want.andnot(bms[0])
    assert got.serialize() == RoaringFormatSpec.serialize(want)
    got = TIX.execute(TIX.and_(*leaves), fused=True)
    want = bms[0]
    for b in bms[1:]:
        want = want & b
    assert got.serialize() == RoaringFormatSpec.serialize(want)
