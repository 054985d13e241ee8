"""Port parity: the fused tree planner and evaluator.

Tapes, slot counts, the packed lift meta and the launch/traffic model must
equal the reference's; the plain-torch ``fused_eval_ref`` must give the same
bits and cards as the reference's XLA formulation on seeded trees of depth
1-5 over operands of every kind (dead columns included), and so must a plain
replay of the program the host derives for the CUDA kernel
(``kernel_program``). The CUDA kernel is held against ``fused_eval_ref`` by
``test_torch_gpu.py`` (on the card) and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import (case_rows, release_jax_executables,  # noqa: F401
                           to_np16, to_t16)
from _torch_threads import share_cores_between_workers
from repro.kernels.roaring import fused as JF
from repro_torch.kernels.roaring import fused as TF

share_cores_between_workers()

SEED = 1402
_jax_fused = jax.jit(JF.fused_eval_ref, static_argnames="plan")
TREES = {
    "leaf": 0,
    "and2": ("and", 0, 1),
    "or3": ("or", 0, 1, 2),
    "andnot": ("andnot", 0, 1),
    "depth3": ("andnot", ("or", 0, 1, 2), ("and", 3, 1)),
    "depth4": ("or", ("and", 0, ("andnot", 1, 2)), ("andnot", 3, ("or", 0, 2))),
    "depth5": ("and", ("or", ("andnot", ("and", 0, 1), 2), 3),
               ("or", 1, ("andnot", 3, ("and", 0, 2)))),
}


@pytest.fixture(scope="module")
def operands():
    """N=4 operands x C=10 columns of rows of every kind; column 9 is dead
    (every operand empty there), column 8 has one live operand."""
    rng = np.random.default_rng(SEED)
    pool = list(case_rows(rng).values())
    N, C = 4, 10
    kind = np.zeros((N, C), np.int32)
    card = np.zeros((N, C), np.int32)
    nruns = np.zeros((N, C), np.int32)
    data = np.zeros((N, C, 4096), np.uint16)
    for n in range(N):
        for c in range(C):
            if c == 9 or (c == 8 and n):
                k, ca, r, d = pool[-1]
            else:
                k, ca, r, d = pool[rng.integers(len(pool))]
            kind[n, c], card[n, c], nruns[n, c], data[n, c] = k, ca, r, d
    return kind, card, nruns, data


def test_plans_and_lift_meta_equal_reference(operands):
    """Tapes, slot counts and the traffic model equal the reference's tape
    for tape; bad trees are refused alike; the packed lift meta is equal."""
    for name, tree in TREES.items():
        pj, pt = JF.plan_tape(tree), TF.plan_tape(tree)
        assert pt.tape == pj.tape, name
        assert (pt.n_slots, pt.n_operands, pt.n_loads, pt.n_ops) == \
            (pj.n_slots, pj.n_operands, pj.n_loads, pj.n_ops), name
        assert TF.plan_stats(pt, 135) == JF.plan_stats(pj, 135)
        assert TF.plan_tape(tree) is pt                    # hash-consed
        enc = TF.encode_tape(pt, "cpu")
        assert enc.shape == (len(pt.tape), 4)
        for row, step in zip(enc.tolist(), pt.tape):
            assert row[0] == TF.TAPE_OPCODES[step[0]]
            assert row[3] == step[-1]

    for bad in [("xor", 0, 1), ("andnot", 0, 1, 2), ("and",)]:
        with pytest.raises(ValueError):
            JF.plan_tape(bad)
        with pytest.raises(ValueError):
            TF.plan_tape(bad)

    kind, card, nruns, _ = operands
    want = np.asarray(JF.pack_lift_meta(jnp.asarray(kind), jnp.asarray(card),
                                        jnp.asarray(nruns)))
    got = TF.pack_lift_meta(torch.from_numpy(kind), torch.from_numpy(card),
                            torch.from_numpy(nruns))
    assert got.dtype == torch.int32
    assert np.array_equal(want, got.numpy())


def test_fused_eval_ref_equals_reference(operands):
    kind, card, nruns, data = operands
    meta = np.array(JF.pack_lift_meta(jnp.asarray(kind), jnp.asarray(card),
                                      jnp.asarray(nruns)))
    leaves = _np_leaves(operands)
    for name, tree in TREES.items():
        plan_j, plan_t = JF.plan_tape(tree), TF.plan_tape(tree)
        bj, cj = _jax_fused(jnp.asarray(data), jnp.asarray(meta), plan=plan_j)
        bt, ct = TF.fused_eval_ref(to_t16(data), torch.from_numpy(meta),
                                   plan=plan_t)
        assert np.array_equal(np.asarray(bj), to_np16(bt)), name
        assert np.array_equal(np.asarray(cj), ct.numpy()), name
        assert ct[9] == 0 and not bt[9].any(), name        # dead column
        assert np.array_equal(_replay_program(plan_t, leaves)[:9],
                              to_np16(bt)[:9]), name
    _check_deep_plan_beyond_shared_memory(operands)


def _np_members(kind, card, nruns, row):
    """Host decode of one raw container row -> u16[4096] bitmap words."""
    bits = np.zeros(1 << 16, bool)
    if kind == 1:
        bits[row[:card]] = True
    elif kind == 2:
        bits = np.unpackbits(row.view(np.uint8), bitorder="little") == 1
    elif kind == 3:
        for s, ln in row.reshape(-1, 2)[:nruns].astype(np.int64):
            bits[s:s + ln + 1] = True
    return np.packbits(bits, bitorder="little").view(np.uint16)


def _np_leaves(operands):
    """Every operand row lifted on the host: u16[N, C, 4096]."""
    kind, card, nruns, data = operands
    return np.stack([np.stack([
        _np_members(kind[n, c], card[n, c], nruns[n, c], data[n, c])
        for c in range(data.shape[1])]) for n in range(data.shape[0])])


def _replay_program(plan, leaves):
    """The CUDA kernel's program as it reads it (``encode_program`` for
    whole rows) replayed in numpy over lifted leaves u16[N, C, 4096]:
    memory is a map from byte offset to row, the top of the stack one
    array. Returns the root u16[C, 4096]."""
    lifts, prog = TF.encode_program(plan, 512, "cpu")
    n = lifts.numel()
    mem = {16 * (n + d * 512): leaves[x] for d, x in enumerate(lifts.tolist())}
    top = np.zeros_like(leaves[0])
    for masks, operand, spill, _ in prog.tolist()[:-TF.PROGRAM_PAD]:
        if spill >= 0:
            mem[spill] = top
        c1, c2, c3 = (np.uint16(0xFFFF * (masks >> k & 1)) for k in range(3))
        y = mem[operand]
        top = (top & c1) ^ (y & c2) ^ (top & y & c3)
    return top


def _np_tree(tree, leaves):
    if isinstance(tree, int):
        return leaves[tree]
    vals = [_np_tree(c, leaves) for c in tree[1:]]
    out = vals[0]
    for v in vals[1:]:
        out = {"and": out & v, "or": out | v, "andnot": out & ~v}[tree[0]]
    return out


def _check_deep_plan_beyond_shared_memory(operands):
    """A right-nested 30-deep tree needs 31 slots (more than one block's
    shared memory holds on the card); its plan equals the reference's and
    the plain version agrees with a host numpy evaluation."""
    kind, card, nruns, data = operands
    tree = 3
    for i in range(30):
        tree = (("and", "or", "andnot")[i % 3], i % 4, tree)
    pj, pt = JF.plan_tape(tree), TF.plan_tape(tree)
    assert pt.n_slots == pj.n_slots == 31 and pt.tape == pj.tape
    meta = TF.pack_lift_meta(torch.from_numpy(kind), torch.from_numpy(card),
                             torch.from_numpy(nruns))
    bt, ct = TF.fused_eval_ref(to_t16(data), meta, plan=pt)
    lifts, steps = TF.kernel_program(pt)
    assert sorted(lifts) == [0, 1, 2, 3] and len(steps) < len(pt.tape)
    assert np.array_equal(_replay_program(pt, _np_leaves(operands))[:9],
                          to_np16(bt)[:9])
    for c in range(data.shape[1]):
        leaves = [_np_members(kind[n, c], card[n, c], nruns[n, c], data[n, c])
                  for n in range(data.shape[0])]
        want = _np_tree(tree, leaves)
        if c == 9:
            want = np.zeros_like(want)                 # dead column
        assert np.array_equal(to_np16(bt[c]), want), c
        assert int(ct[c]) == int(np.unpackbits(want.view(np.uint8)).sum())
