"""The CUDA kernels against their plain-torch versions, on the card.

Every test here needs an NVIDIA card. The module skips as a whole without
one, so that a machine without one collects none of its tests. Run them on
the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX: the machine with the card has none. Outputs are
integers, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA card (run on the chip)",
                allow_module_level=True)

from _torch_parity import (KIND_CASES, case_rows, container_row,  # noqa
                           cuda, pair_grid, to_t16)
from repro_torch.kernels.roaring.dispatch import (  # noqa: E402
    KIND_ARRAY, KIND_BITMAP, KIND_RUN)
from repro_torch import search  # noqa: E402
from repro_torch.kernels.roaring import fused as TF  # noqa: E402
from repro_torch.kernels.roaring import kernel as TK  # noqa: E402
from repro_torch.kernels.roaring import ops as TOPS  # noqa: E402
from repro_torch.kernels.roaring import ref as TR  # noqa: E402

pytestmark = pytest.mark.gpu

SEED = 1402
CASES = sorted(KIND_CASES) + ["empty"]


@pytest.fixture(scope="module")
def pairs():
    A, B, meta = pair_grid(case_rows(np.random.default_rng(SEED)), CASES,
                           CASES)
    return to_t16(A), to_t16(B), torch.from_numpy(meta)


def test_dispatch_kernel_every_kind_pair_and_shared_query(pairs, cuda):
    """Hits and cards of every kind pair; then the card-only stacked launch
    that reads one shared query's rows by ``row % C``."""
    A, B, meta = pairs
    ht, ct = TR.intersect_dispatch_ref(A, B, meta)
    hk, ck = TK.intersect_dispatch_cuda(A.to(cuda), B.to(cuda), meta.to(cuda))
    assert torch.equal(hk.cpu(), ht) and torch.equal(ck.cpu(), ct)
    C = len(CASES)                  # b rows 0..C-1 are row 0's partners
    q = B[:C].contiguous()
    m = meta.reshape(-1, 6).clone()
    m[:, 1::2] = m[:C, 1::2].repeat(len(CASES), 1)   # query side per row % C
    N = A.shape[0] // C
    want = TOPS.stacked_and_card(A.reshape(N, C, -1), q, m.reshape(N, 6 * C))
    got = TOPS.stacked_and_card(A.reshape(N, C, -1).to(cuda), q.to(cuda),
                                m.reshape(N, 6 * C).to(cuda))
    assert torch.equal(got.cpu(), want)


def _run_row(n_runs):
    """A run row of ``n_runs`` runs of 16 values, 32 apart (2,048 runs is
    the most a row holds)."""
    row = np.full(4096, 0xFFFF, np.uint16)
    row[0:2 * n_runs:2] = 32 * np.arange(n_runs)
    row[1:2 * n_runs:2] = 15
    return KIND_RUN, 16 * n_runs, n_runs, row


def _stack(rows, names_a, query_names, N, rng, dead_a=()):
    """N slabs x C columns against one query: column c's query row is
    ``query_names[c]``; each pair's a-side a random row of ``names_a``
    (EMPTY in the columns ``dead_a``). Returns (A int16[N, C, 4096], query
    int16[C, 4096], meta i32[N, 6C])."""
    C = len(query_names)
    pick = rng.integers(0, len(names_a), size=(N, C))
    A = np.empty((N, C, 4096), np.uint16)
    meta = np.empty((N, C, 6), np.int32)
    for c, qn in enumerate(query_names):
        kq, cq, rq, _ = rows[qn]
        for n in range(N):
            ka, ca, ra, da = rows["empty" if c in dead_a
                                  else names_a[pick[n, c]]]
            A[n, c] = da
            meta[n, c] = (ka, kq, ca, cq, ra, rq)
    q = np.stack([rows[qn][3] for qn in query_names])
    return to_t16(A), to_t16(q), torch.from_numpy(meta.reshape(N, 6 * C))


@pytest.mark.parametrize("lanes", [None, 8, 32])
@pytest.mark.parametrize("shape", ["300x9 every query kind", "3x200",
                                   "13x7", "40x5 dead columns"])
def test_stacked_card_schedule_matches_plain_version(shape, lanes, cuda,
                                                     monkeypatch):
    """The card-only kernel (8 or 32 lanes a pair, the query staged once per
    block) at the search's N >> C, the store's N << C, N * C off a multiple
    of the block's pair groups and all-dead columns, with the lanes its
    plan picks (None) and with each instantiation forced: bit for bit
    against the plain version."""
    if lanes is not None:
        plan = TK.stacked_plan
        monkeypatch.setattr(TK, "stacked_plan", lambda n, c, sm: (
            plan(n, c, sm)[0], lanes))
    rng = np.random.default_rng(SEED)
    rows = case_rows(rng)
    rows["run_2048"] = _run_row(2048)
    kinds = sorted(rows)                 # every kind, empty and 2048 runs
    dead = ()
    if shape == "300x9 every query kind":
        N, cols = 300, [k for k in kinds if k != "empty"]
    elif shape == "3x200":
        N, cols = 3, [kinds[i % len(kinds)] for i in range(200)]
    elif shape == "13x7":
        N, cols = 13, kinds[:7]
    else:                                # an empty query; an all-empty a side
        N, cols, dead = 40, ["empty", "bitmap_dense", "run_2048",
                             "array_small", "run_full"], (1, 3)
    A, q, m = _stack(rows, kinds, cols, N, rng, dead)
    want = TOPS.stacked_and_card(A, q, m)
    got = TOPS.stacked_and_card(A.to(cuda), q.to(cuda), m.to(cuda))
    assert torch.equal(got.cpu(), want)
    assert bool((want > 0).any())


def test_dispatch_hits_at_card_boundaries(cuda):
    """The key-aligned kernel's hits rows where the array side fills its
    last 16-byte chunk (4,096 values) or stops one slot short (4,095),
    against arrays, a 4,097-value bitmap and runs, both ways round."""
    rng = np.random.default_rng(SEED)
    vals = np.sort(rng.choice(1 << 16, 4097, replace=False))
    rows = {"a4096": container_row(vals[:4096]),
            "a4095": container_row(vals[1:4096]),
            "b4097": container_row(vals),
            "r_full": container_row(np.arange(1 << 16)),
            "r_2048": _run_row(2048)}
    assert [rows[k][:2] for k in ("a4096", "a4095", "b4097")] == [
        (KIND_ARRAY, 4096), (KIND_ARRAY, 4095), (KIND_BITMAP, 4097)]
    A, B, meta = pair_grid(rows, list(rows), list(rows))
    A, B, meta = to_t16(A), to_t16(B), torch.from_numpy(meta)
    ht, ct = TR.intersect_dispatch_ref(A, B, meta)
    hk, ck = TK.intersect_dispatch_cuda(A.to(cuda), B.to(cuda), meta.to(cuda))
    assert torch.equal(hk.cpu(), ht) and torch.equal(ck.cpu(), ct)
    assert int(ct.max()) == 1 << 16 and 4096 in ct.tolist()


TREES = [0, ("and", 0, 1), ("or", 0, 1, 2), ("andnot", 0, 1),
         ("andnot", ("or", 0, 1, 2), ("and", 3, 1)),
         ("and", ("or", ("andnot", ("and", 0, 1), 2), 3),
          ("or", 1, ("andnot", 3, ("and", 0, 2))))]


def _deep_tree(depth):
    tree = 3
    for i in range(depth):
        tree = (("and", "or", "andnot")[i % 3], i % 4, tree)
    return tree


def _bsi_le_tree(k, bits, universe=0):
    """``store.BitmapStore._bsi_le`` over slices 1..bits: rows whose value
    is at most ``k``, with NOT x = ``universe`` ANDNOT x, so the universe
    leaf and every slice come back many times."""
    below, prefix = [], None
    for j in reversed(range(bits)):
        s_j, not_j = 1 + j, ("andnot", universe, 1 + j)
        if (k >> j) & 1:
            below.append(not_j if prefix is None else ("and", prefix, not_j))
            prefix = s_j if prefix is None else ("and", prefix, s_j)
        else:
            prefix = not_j if prefix is None else ("and", prefix, not_j)
    return ("or", *below, prefix)


def _fused_operands(N, C, rng, universe=False):
    """N operands x C columns of the kind-case rows drawn by ``rng``; the
    last column dead; with ``universe``, operand 0 is the run row covering
    the chunk in every live column."""
    rows = case_rows(np.random.default_rng(SEED))
    names = sorted(rows)
    pick = rng.integers(0, len(names), (N, C))
    if universe:
        pick[0] = names.index("run_full")
    kind, card, nr = (np.array([[rows[names[i]][f] for i in r]
                                for r in pick], np.int32) for f in range(3))
    kind[:, C - 1] = 0                                  # one dead column
    data = np.stack([np.stack([rows[names[i]][3] for i in r]) for r in pick])
    return to_t16(data), TF.pack_lift_meta(
        torch.from_numpy(kind), torch.from_numpy(card), torch.from_numpy(nr))


def test_fused_kernel_matches_plain_version(pairs, cuda):
    """Trees of depth 1-5 at every launch shape the kernel is built for; a
    ``_bsi_le``-shaped tree that repeats its operands and a run row
    covering the chunk; a 31-slot plan (in shared memory); a
    61-slot plan past the stack's room in shared memory and a 64-operand
    plan, both in global scratch."""
    A, B, meta = pairs
    m = meta.reshape(-1, 6)
    N, C = 4, 20
    ops = torch.stack([A[:N * C], B[:N * C]]).reshape(2 * N, C, -1)[:N]
    kind = torch.stack([m[:N * C, 0], m[:N * C, 1]]).reshape(2 * N, C)[:N]
    card = torch.stack([m[:N * C, 2], m[:N * C, 3]]).reshape(2 * N, C)[:N]
    nr = torch.stack([m[:N * C, 4], m[:N * C, 5]]).reshape(2 * N, C)[:N]
    kind[:, C - 1] = 0                                  # one dead column
    lm = TF.pack_lift_meta(kind.contiguous(), card.contiguous(),
                           nr.contiguous())
    rng = np.random.default_rng(SEED)
    bsi_ops, bsi_lm = _fused_operands(6, C, rng, universe=True)
    wide_ops, wide_lm = _fused_operands(64, C, rng)
    bsi = ("and", 5, ("andnot", _bsi_le_tree(12, 4), _bsi_le_tree(3, 4)))
    wide = ("or", ("and", 0, 1), *[(("and", "andnot")[i % 2], i, i + 1)
                                   for i in range(2, 63)])
    smem = TK.fused_smem(cuda)
    cases = [(t, ops, lm)
             for t in TREES + [_deep_tree(30), _deep_tree(60)]]
    cases += [(bsi, bsi_ops, bsi_lm), (wide, wide_ops, wide_lm)]
    picked = {}
    for tree, o, meta_ in cases:
        plan = TF.plan_tape(tree)
        n_lifts = len(TF.kernel_program(plan)[0])
        bt, ct = TF.fused_eval_ref(o.contiguous(), meta_, plan=plan)
        o_c, m_c = o.contiguous().to(cuda), meta_.to(cuda)
        for shape in TK.fused_shapes(n_lifts, plan.n_slots, smem[0]):
            bk, ck = TK.fused_eval_cuda(o_c, m_c, plan, shape=shape)
            assert torch.equal(bk.cpu(), bt) and torch.equal(ck.cpu(), ct), \
                (plan.n_slots, shape)
        bk, ck = TK.fused_eval_cuda(o_c, m_c, plan)
        assert torch.equal(bk.cpu(), bt) and torch.equal(ck.cpu(), ct)
        picked[plan.n_slots, n_lifts] = TK.fused_launch_shape(
            n_lifts, plan.n_slots, *smem)
    plan = TF.plan_tape(bsi)
    assert plan.n_loads > 2 * len(TF.kernel_program(plan)[0])
    assert picked[31, 4][2]
    assert not picked[61, 4][2] and not picked[3, 64][2]


def test_service_on_card_equals_service_on_cpu(cuda):
    rng = np.random.default_rng(SEED)
    n_docs = 200_000
    postings = {f"t{i:02d}": np.unique(rng.integers(
        0, n_docs, max(4, int(0.4 * n_docs * (i + 1) ** -1.2))))
        for i in range(10)}
    t = search.term
    qs = [search.and_(t("t00"), t("t01")), search.or_(t("t02"), t("t05")),
          search.andnot(t("t00"), t("t03")),
          search.andnot(search.or_(t("t01"), t("t06")),
                        search.and_(t("t00"), t("t02")))]
    out = {}
    for dev in ("cpu", "cuda"):
        idx = search.PostingIndex.from_postings(postings, n_docs, device=dev)
        for fused in (True, False):
            svc = search.SearchService(idx, max_batch=4, fused=fused)
            out[dev, fused] = (svc.search_many(qs, "count"),
                               svc.search_many(qs, "docs"),
                               svc.search_many(qs[:2], "topk", k=5))
    ref = out["cpu", True]
    for key, got in out.items():
        assert got[0] == ref[0] and got[2] == ref[2], key
        for a, b in zip(got[1], ref[1]):
            assert np.array_equal(a, b), key
