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

from _torch_parity import (KIND_CASES, case_rows, cuda,  # noqa: F401,E402
                           pair_grid, to_t16)
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


TREES = [0, ("and", 0, 1), ("or", 0, 1, 2), ("andnot", 0, 1),
         ("andnot", ("or", 0, 1, 2), ("and", 3, 1)),
         ("and", ("or", ("andnot", ("and", 0, 1), 2), 3),
          ("or", 1, ("andnot", 3, ("and", 0, 2))))]


def _deep_tree(depth):
    tree = 3
    for i in range(depth):
        tree = (("and", "or", "andnot")[i % 3], i % 4, tree)
    return tree


def test_fused_kernel_matches_plain_version(pairs, cuda):
    """Trees of depth 1-5 and a 31-slot plan beyond shared memory."""
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
    for tree in TREES + [_deep_tree(30)]:
        plan = TF.plan_tape(tree)
        bt, ct = TF.fused_eval_ref(ops.contiguous(), lm, plan=plan)
        bk, ck = TK.fused_eval_cuda(ops.contiguous().to(cuda), lm.to(cuda),
                                    plan)
        assert torch.equal(bk.cpu(), bt) and torch.equal(ck.cpu(), ct), \
            plan.n_slots


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
