"""Port parity: the dispatch registry, the kind-dispatch intersection and
the word-op and packed-array container kernels.

The same seeded container rows go through the reference's XLA formulation
(``repro.kernels.roaring.ref``) and the port's plain-torch version
(``repro_torch.kernels.roaring.ref``); hits and cards must be equal as
integers. ``container_op`` (all four ops) and ``array_intersect`` are also
held bit for bit against the reference's Pallas kernels in interpret mode,
on ``cases.container_pairs`` / ``cases.array_pairs``. The registry must
equal the reference's field by field, and the CUDA kernel's generated cell
switch must encode it. The CUDA kernels themselves are held against the
plain versions by ``test_torch_gpu.py`` / ``test_torch_gpu_store.py`` (on
the card) and by ``chip_smoke.py``.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (KIND_CASES, case_rows, pair_grid,  # noqa: F401
                           release_jax_executables, to_np16, to_t16)
from repro.kernels.roaring import dispatch as JD
from repro.kernels.roaring import kernel as JK
from repro.kernels.roaring import ops as JOPS
from repro.kernels.roaring import ref as JR
from repro_torch.kernels.roaring import cases as TC
from repro_torch.kernels.roaring import dispatch as TD
from repro_torch.kernels.roaring import kernel as TK
from repro_torch.kernels.roaring import ops as TOPS
from repro_torch.kernels.roaring import ref as TR

SEED = 1402
CASES = sorted(KIND_CASES) + ["empty"]
_jax_dispatch = jax.jit(JR.intersect_dispatch_ref)     # compiled once


@pytest.fixture(scope="module")
def rows():
    return case_rows(np.random.default_rng(SEED))


def _both(A, B, meta):
    hj, cj = _jax_dispatch(jnp.asarray(A), jnp.asarray(B), jnp.asarray(meta))
    ht, ct = TR.intersect_dispatch_ref(to_t16(A), to_t16(B),
                                       torch.from_numpy(meta))
    return (np.asarray(hj), np.asarray(cj)), (to_np16(ht), ct.numpy())


# =============================================================================
# the registry
# =============================================================================

def _check_and_table():
    assert len(TD.AND_TABLE) == len(JD.AND_TABLE) == 9
    for t, j in zip(TD.AND_TABLE, JD.AND_TABLE):
        for f in ("name", "kind_a", "kind_b", "kernel", "out", "swap",
                  "slab_route"):
            assert getattr(t, f) == getattr(j, f), (t.name, f)
    for name in ("ROW_WORDS", "MAX_RUNS", "KIND_EMPTY", "KIND_ARRAY",
                 "KIND_BITMAP", "KIND_RUN", "META_FIELDS"):
        assert getattr(TD, name) == getattr(JD, name)


def _check_routing_predicates():
    ka, kb = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    ka, kb = ka.ravel().astype(np.int32), kb.ravel().astype(np.int32)
    ca = np.array([0, 10, 5000, 300] * 4, np.int32)
    cb = np.array([4000, 90, 0, 4096] * 4, np.int32)
    tj = [jnp.asarray(x) for x in (ka, kb, ca, cb)]
    tt = [torch.from_numpy(x) for x in (ka, kb, ca, cb)]
    for out in ("bits", "mask_a", "mask_b"):
        assert np.array_equal(np.asarray(JD.out_mask(out, *tj[:2])),
                              TD.out_mask(out, *tt[:2]).numpy())
    assert np.array_equal(np.asarray(JD.route_mask("run_merge", *tj[:2])),
                          TD.route_mask("run_merge", *tt[:2]).numpy())
    for a, b in zip(JD.union_route(*tj, 4096), TD.union_route(*tt, 4096)):
        assert np.array_equal(np.asarray(a), b.numpy())
    for a, b in zip(JD.andnot_route(*tj[:2]), TD.andnot_route(*tt[:2])):
        assert np.array_equal(np.asarray(a), b.numpy())
    meta = np.arange(12, dtype=np.int32)
    for a, b in zip(JD.unpack_meta(jnp.asarray(meta)),
                    TD.unpack_meta(torch.from_numpy(meta))):
        assert np.array_equal(np.asarray(a), b.numpy())


def _check_generated_cuda_cell_switch():
    src = TK.and_table_source()
    ids = dict(re.findall(r"#define RK_(\w+) (\d+)", src))

    def table(name):
        body = re.search(name + r"\[4\]\[4\] = \{(.*)\};", src).group(1)
        return [[int(v) for v in re.findall(r"\d+", row)]
                for row in re.findall(r"\{([^{}]*)\}", body)]

    kid, swap = table("AND_KERNEL"), table("AND_SWAP")
    seen = set()
    for cls in JD.AND_TABLE:
        assert kid[cls.kind_a][cls.kind_b] == int(ids[cls.kernel.upper()])
        assert swap[cls.kind_a][cls.kind_b] == int(cls.swap)
        seen.add((cls.kind_a, cls.kind_b))
    for a in range(4):
        for b in range(4):
            if (a, b) not in seen:           # an empty side: the dead cell
                assert kid[a][b] == int(ids["NONE"]) == 0


def test_registry_equals_reference():
    """AND_TABLE field by field, the constants, the routing predicates, and
    the CUDA kernel's generated cell switch."""
    _check_and_table()
    _check_routing_predicates()
    _check_generated_cuda_cell_switch()


# =============================================================================
# intersect_dispatch: every kind pair, the 4095/4096/4097 boundaries
# =============================================================================

def test_intersect_dispatch_every_kind_pair(rows):
    """Every (kind, boundary) pair: hits and cards equal the reference's,
    and the cards equal a host set-intersection oracle; the stacked entry
    and the card-only stacked entry equal the reference's stacked entry."""
    for name_a in CASES:
        A, B, meta = pair_grid(rows, [name_a], CASES)
        (hj, cj), (ht, ct) = _both(A, B, meta)
        assert np.array_equal(hj, ht), name_a
        assert np.array_equal(cj, ct), name_a
    A, B, meta = pair_grid(rows, CASES, CASES)
    _, ct = TR.intersect_dispatch_ref(to_t16(A), to_t16(B),
                                      torch.from_numpy(meta))
    vals = {n: set(_values(rows[n])) for n in CASES}
    want = [len(vals[a] & vals[b]) for a in CASES for b in CASES]
    assert ct.tolist() == want
    _check_stacked_entry(rows)
    _check_card_only_stacked(rows)


def _values(row):
    kind, card, nr, data = row
    if kind == 1:
        return data[:card].tolist()
    if kind == 2:
        bits = np.unpackbits(data.view(np.uint8), bitorder="little")
        return np.nonzero(bits)[0].tolist()
    if kind == 3:
        p = data.reshape(-1, 2).astype(np.int64)[:nr]
        return [v for s, l in p for v in range(s, s + l + 1)]
    return []


def _check_stacked_entry(rows):
    A, B, meta = pair_grid(rows, CASES[:6], CASES[3:])
    N, C = 6, A.shape[0] // 6
    A3, B3 = A.reshape(N, C, -1), B.reshape(N, C, -1)
    m2 = meta.reshape(N, 6 * C)
    hj, cj = JOPS.intersect_dispatch_stacked(jnp.asarray(A3), jnp.asarray(B3),
                                             jnp.asarray(m2))
    ht, ct = TOPS.intersect_dispatch_stacked(to_t16(A3), to_t16(B3),
                                             torch.from_numpy(m2))
    assert ht.shape == (N, C, 4096) and ct.shape == (N, C)
    assert np.array_equal(np.asarray(hj), to_np16(ht))
    assert np.array_equal(np.asarray(cj), ct.numpy())


def _check_card_only_stacked(rows):
    """``stacked_and_card`` (query rows passed once) == the broadcast
    stacked entry's card."""
    A, _, _ = pair_grid(rows, CASES, CASES[:1])
    q_names = CASES[:3]
    N, C = A.shape[0] // 3, 3
    A3 = A[: N * C].reshape(N, C, -1)
    q = np.stack([rows[n][3] for n in q_names])
    qmeta = [(rows[n][0], rows[n][1], rows[n][2]) for n in q_names]
    meta = []
    for i in range(N * C):
        ka, ca, ra, _ = rows[CASES[i]]
        kb, cb, rb = qmeta[i % C]
        meta += [ka, kb, ca, cb, ra, rb]
    m2 = np.asarray(meta, np.int32).reshape(N, 6 * C)
    card = TOPS.stacked_and_card(to_t16(A3), to_t16(q), torch.from_numpy(m2))
    _, want = JOPS.intersect_dispatch_stacked(
        jnp.asarray(A3), jnp.asarray(np.broadcast_to(q, A3.shape)),
        jnp.asarray(m2))
    assert np.array_equal(card.numpy(), np.asarray(want))


# =============================================================================
# container_op / array_intersect against the Pallas kernels and oracles
# =============================================================================

def test_container_kernels_equal_reference():
    """Both entry points on CPU tensors, bit for bit (tolerance 0), against
    ``container_op_pallas`` / ``array_intersect_pallas`` in interpret mode
    and the reference's XLA oracles, on every pair of the case grids."""
    rng = np.random.default_rng(SEED)
    A, B, kinds = TC.container_pairs(rng)
    dead = (kinds[0::2] == 0) & (kinds[1::2] == 0)
    assert dead.sum() == 4 and (A[dead] != 0).any()   # garbage payload
    for op in TC.CONTAINER_OPS:
        out, card = TOPS.container_op(to_t16(A), to_t16(B),
                                      torch.from_numpy(kinds), op)
        assert out.dtype == torch.int16 and card.dtype == torch.int32
        for jo, jc in (
                JK.container_op_pallas(jnp.asarray(A), jnp.asarray(B),
                                       jnp.asarray(kinds), op,
                                       interpret=True),
                JR.container_op_ref(jnp.asarray(A), jnp.asarray(B),
                                    jnp.asarray(kinds), op)):
            assert np.array_equal(to_np16(out), np.asarray(jo)), op
            assert np.array_equal(card.numpy(), np.asarray(jc)), op
        assert not to_np16(out)[dead].any() and not card.numpy()[dead].any()
    A, B, cards = TC.array_pairs(rng)
    hits, count = TOPS.array_intersect(to_t16(A), to_t16(B),
                                       torch.from_numpy(cards))
    assert hits.dtype == torch.int16 and count.dtype == torch.int32
    for jh, jc in (
            JK.array_intersect_pallas(jnp.asarray(A), jnp.asarray(B),
                                      jnp.asarray(cards), interpret=True),
            JR.array_intersect_ref(jnp.asarray(A), jnp.asarray(B),
                                   jnp.asarray(cards))):
        assert np.array_equal(to_np16(hits), np.asarray(jh))
        assert np.array_equal(count.numpy(), np.asarray(jc))
    # the host oracle: |A[:card_a] ∩ B[:card_b]| per pair, 65535 included
    want = [np.intersect1d(a[:ca], b[:cb]).size
            for a, b, ca, cb in zip(A, B, cards[0::2], cards[1::2])]
    assert count.tolist() == want
    assert any(65535 in set(a[:ca]) & set(b[:cb]) for a, b, ca, cb in
               zip(A, B, cards[0::2], cards[1::2]))


def test_lifts_match_reference(rows):
    runs = [rows[n] for n in CASES if rows[n][0] == 3]
    R = np.stack([r[3] for r in runs])
    want = np.stack([np.asarray(JD.coverage_by_scatter(
        jnp.asarray(r.reshape(32, 128)), jnp.int32(0))).reshape(-1)
        for r in R])
    got = TD.coverage_by_scatter(TD.widen(to_t16(R)))
    assert np.array_equal(want, got.numpy())
    arrs = [rows[n] for n in CASES if rows[n][0] == 1]
    Ar = np.stack([r[3] for r in arrs])
    cards = np.asarray([r[1] for r in arrs], np.int32)
    want = np.stack([np.asarray(JD.array_coverage_by_scatter(
        jnp.asarray(a.reshape(32, 128)), jnp.int32(c))).reshape(-1)
        for a, c in zip(Ar, cards)])
    got = TD.array_coverage_by_scatter(TD.widen(to_t16(Ar)),
                                       torch.from_numpy(cards))
    assert np.array_equal(want, got.numpy())


# =============================================================================
# entry-point plumbing (no card needed)
# =============================================================================

def _check_launch_hooks_fire_before_the_fault_hook(rows):
    A, B, meta = pair_grid(rows, CASES[:2], CASES[:2])
    order = []
    hook = lambda ev: order.append(("launch", ev.entry, ev.backend))  # noqa

    def fault(backend):
        order.append(("fault", backend))
        raise RuntimeError("boom")

    kinds = torch.from_numpy(meta.reshape(-1, 6)[:, :2].reshape(-1).copy())
    cards = torch.from_numpy(meta.reshape(-1, 6)[:, 2:4].reshape(-1).copy())
    calls = {"intersect_dispatch": lambda: TOPS.intersect_dispatch(
                 to_t16(A), to_t16(B), torch.from_numpy(meta)),
             "container_op": lambda: TOPS.container_op(
                 to_t16(A), to_t16(B), kinds, "xor"),
             "array_intersect": lambda: TOPS.array_intersect(
                 to_t16(A), to_t16(B), cards)}
    TOPS.add_launch_hook(hook)
    prev = TOPS.set_fault_hook(fault)
    try:
        for call in calls.values():
            with pytest.raises(RuntimeError, match="boom"):
                call()
    finally:
        TOPS.set_fault_hook(prev)
        TOPS.remove_launch_hook(hook)
    assert order == [x for entry in calls
                     for x in (("launch", entry, "torch"),
                               ("fault", "torch"))]
    with pytest.raises(ValueError, match="unknown container op"):
        TOPS.container_op(to_t16(A), to_t16(B), kinds, "nand")


def _check_backend_scope_names_and_nesting():
    with pytest.raises(ValueError, match="unknown roaring backend"):
        with TOPS.backend_scope("pallas"):
            pass
    assert TOPS.current_backend("cpu") == "torch"
    with TOPS.backend_scope("cuda"):
        assert TOPS.current_backend("cpu") == "cuda"
        with TOPS.backend_scope("auto"):
            assert TOPS.current_backend("cpu") == "torch"
        assert TOPS.current_backend("cpu") == "cuda"


def _check_cuda_wrappers_refuse_cpu_tensors(rows):
    A, B, meta = pair_grid(rows, CASES[:2], CASES[:2])
    for want_hits in (True, False):
        with pytest.raises(ValueError, match="CUDA tensor"):
            TK.intersect_dispatch_cuda(to_t16(A), to_t16(B),
                                       torch.from_numpy(meta),
                                       want_hits=want_hits)
    tags = torch.zeros(2 * A.shape[0], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TK.container_op_cuda(to_t16(A), to_t16(B), tags, "and")
    with pytest.raises(ValueError, match="CUDA tensor"):
        TK.array_intersect_cuda(to_t16(A), to_t16(B), tags)
    assert {"container_op", "array_intersect"} <= set(TK.launch_counts)


def _check_stacked_plan_fills_the_card():
    """The card-only launch's grid split and lanes a pair come from shapes
    alone: the search's 2049 x 135 grid and the store's 24 x 916 sum_ fill
    the 132 SMs of an H100, and a group of lanes short of a warp walks two
    pairs or more."""
    for n, c in [(2049, 135), (24, 916), (3, 916), (1, 1), (300, 9),
                 (13, 7), (100_000, 1), (64, 4096)]:
        split, lanes = TK.stacked_plan(n, c, 132)
        assert 1 <= split <= min(65535, max(1, -(-n // 64)))
        assert lanes in (8, 32)
        assert lanes == 32 or 2 * split * 32 <= n
    for (n, c), want in {(2049, 135): (16, 8), (24, 916): (1, 32)}.items():
        assert TK.stacked_plan(n, c, 132) == want and c * want[0] >= 132


def test_entry_point_plumbing(rows):
    _check_launch_hooks_fire_before_the_fault_hook(rows)
    _check_backend_scope_names_and_nesting()
    _check_cuda_wrappers_refuse_cpu_tensors(rows)
    _check_stacked_plan_fills_the_card()
