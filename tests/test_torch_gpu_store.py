"""The word-op and packed-array CUDA kernels, the object API and the store,
on the card.

The module skips as a whole without a CUDA card, so that a machine without
one collects none of its tests. Run them on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_store.py

This file imports no JAX: the machine with the card has none. Every check
is exact: the kernels and their plain versions return integers.
"""

import numpy as np
import pytest
import torch

if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA card (run on the chip)",
                allow_module_level=True)

from repro_torch import roaring  # noqa: E402
from repro_torch import store  # noqa: E402
from repro_torch.core import py_roaring as pr  # noqa: E402
from repro_torch.kernels.roaring import cases  # noqa: E402
from repro_torch.kernels.roaring import kernel as K  # noqa: E402
from repro_torch.kernels.roaring import ops  # noqa: E402
from repro_torch.kernels.roaring import ref  # noqa: E402

pytestmark = pytest.mark.gpu

SEED = 1402


def _t(a, device):
    return torch.from_numpy(np.ascontiguousarray(a).view(
        np.int16 if a.dtype == np.uint16 else a.dtype)).to(device)


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


def _random_pairs(rng, n):
    """``n`` random bitmap-domain row pairs and kind tags, a tenth of them
    both EMPTY over garbage payload."""
    A = rng.integers(0, 1 << 16, (n, 4096)).astype(np.uint16)
    B = rng.integers(0, 1 << 16, (n, 4096)).astype(np.uint16)
    kinds = rng.integers(1, 4, 2 * n).astype(np.int32)
    dead = rng.random(n) < 0.1
    kinds[0::2][dead] = 0
    kinds[1::2][dead] = 0
    return A, B, kinds


@pytest.mark.parametrize("op", cases.CONTAINER_OPS)
def test_container_op_kernel_matches_plain_version(op):
    rng = np.random.default_rng(SEED)
    for A, B, kinds in (cases.container_pairs(rng), _random_pairs(rng, 1),
                        _random_pairs(rng, 3000)):
        a, b, k = (_t(x, "cuda") for x in (A, B, kinds))
        got = K.container_op_cuda(a, b, k, op)
        torch.cuda.synchronize()
        _same(got, ref.container_op_ref(a, b, k, op))


def _span_pairs(rng):
    """Packed-array pairs at the kernel's span edges: card_a on and beside
    multiples of 16 and 32 (spans that straddle card_a), card_a = 4,096,
    card_b = 0 over a padded row, and 65,535 in A alone, in B alone and in
    both. Each (A, B) pair comes twice: B drawn apart from A, and B holding
    half its values from A's."""
    def row(vals):
        r = np.full(4096, 0xFFFF, np.uint16)
        r[:len(vals)] = vals
        return len(vals), r

    def pick(n, top=False):
        v = np.sort(rng.choice(65535, n - top, replace=False))
        return np.concatenate([v, [65535]]) if top else v

    def shared(ra, ca, cb):
        take = min(ca, cb // 2)
        mine = ra[:ca][rng.choice(ca, take, replace=False)]
        rest = rng.choice(np.setdiff1d(np.arange(1 << 16), mine),
                          cb - take, replace=False)
        return np.sort(np.concatenate([mine, rest]))

    a_rows = [row(pick(n)) for n in (1, 15, 16, 17, 31, 33, 100, 4080,
                                     4095, 4096)]
    a_rows += [row(pick(n, top=True)) for n in (17, 4096)]
    b_cards = [(0, False), (1, False), (17, False), (1500, False),
               (4096, False), (33, True), (4096, True)]
    A, B, cards = [], [], []
    for ca, ra in a_rows:
        for cb, top in b_cards:
            for vals in (pick(cb, top), shared(ra, ca, cb)):
                A.append(ra)
                B.append(row(vals)[1])
                cards += [ca, cb]
    return np.stack(A), np.stack(B), np.asarray(cards, np.int32)


def test_array_intersect_kernel_matches_plain_version():
    rng = np.random.default_rng(SEED)
    grids = [cases.array_pairs(rng), _span_pairs(rng)]
    n = 2000
    A = np.full((n, 4096), 0xFFFF, np.uint16)
    B = np.full((n, 4096), 0xFFFF, np.uint16)
    cards = rng.integers(0, 4097, 2 * n).astype(np.int32)
    for i in range(n):
        for row, c in ((A[i], cards[2 * i]), (B[i], cards[2 * i + 1])):
            row[:c] = np.sort(rng.choice(1 << 16, c, replace=False))
    grids.append((A, B, cards))
    for A, B, cards in grids:
        a, b, c = (_t(x, "cuda") for x in (A, B, cards))
        got = K.array_intersect_cuda(a, b, c)
        torch.cuda.synchronize()
        _same(got, ref.array_intersect_ref(a, b, c))


def test_entry_points_launch_on_the_card():
    rng = np.random.default_rng(SEED)
    A, B, kinds = cases.container_pairs(rng)
    K.reset_launch_counts()
    out, card = ops.container_op(_t(A, "cuda"), _t(B, "cuda"),
                                 _t(kinds, "cuda"), "andnot")
    A, B, cards = cases.array_pairs(rng)
    hits, count = ops.array_intersect(_t(A, "cuda"), _t(B, "cuda"),
                                      _t(cards, "cuda"))
    assert out.is_cuda and hits.is_cuda
    assert K.launch_counts["container_op"] == 1
    assert K.launch_counts["array_intersect"] == 1
    with ops.backend_scope("torch"):
        with pytest.raises(ValueError, match="only on CPU tensors"):
            ops.array_intersect(_t(A, "cuda"), _t(B, "cuda"),
                                _t(cards, "cuda"))


def _slab(vals, device):
    rb = pr.RoaringBitmap.from_sorted_unique(vals).run_optimize()
    return roaring.RoaringSlab.from_roaring(rb, 4, device=device)


def test_object_api_on_card_equals_cpu():
    rng = np.random.default_rng(SEED)
    sets = [np.unique(np.concatenate([
        rng.integers(0, 4 << 16, 500 + 300 * i),
        np.arange((2 << 16) + 100 * i, (2 << 16) + 20000),
        (3 << 16) + rng.integers(0, 1 << 16, 9000)])) for i in range(3)]
    for dev in ("cuda", "cpu"):
        s = [_slab(v, dev) for v in sets]
        out = [(s[0] & s[1]).serialize(), (s[0] | s[2]).serialize(),
               (s[1] ^ s[2]).serialize(), (s[2] - s[0]).serialize(),
               roaring.union_all(s).serialize(),
               roaring.intersect_all(s).serialize(),
               int(s[0].and_card(s[2])),
               s[1].select(torch.arange(0, 3000, 7)).cpu().tolist(),
               s[1].contains(torch.arange(0, 4 << 16, 97)).cpu().tolist()]
        if dev == "cuda":
            on_card = out
    assert on_card == out


def test_store_query_on_card_equals_cpu():
    rng = np.random.default_rng(SEED)
    n = 200_000
    records = {"a": rng.integers(0, 40, n), "b": rng.integers(0, 5, n),
               "v": rng.integers(0, 1000, n)}
    preds = [store.eq("a", 7),
             store.and_(store.in_("a", [1, 2, 3]), store.range_("v", 10,
                                                                 400)),
             store.or_(store.not_(store.eq("b", 2)), store.range_("v", None,
                                                                  30))]
    answers = {}
    for dev in ("cuda", "cpu"):
        s = store.BitmapStore.build(records, bsi=("v",), device=dev)
        answers[dev] = [s.save()] + [
            (s.query(p, fused=f).serialize(), s.count(p, fused=f))
            for p in preds for f in (False, True)] + [
            s.sum_("v", p) for p in preds]
        if dev == "cuda":
            blob = answers[dev][0]
            assert store.BitmapStore.load(blob, check=True).save() == blob
    assert answers["cuda"] == answers["cpu"]
