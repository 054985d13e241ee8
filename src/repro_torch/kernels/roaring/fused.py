"""Fused expression-tree evaluation: one kernel launch per Boolean tree.

The per-op executor (``index.engine._eval``) launches one dispatch per AND
combine and keeps every intermediate row state in device memory. The fused
evaluator instead replays a whole tree per container column:

  * **plan** (``plan_tape``): the static expression shape is topo-ordered
    into a *tape* — a left-fold post-order sequence of ``("load", operand,
    slot)`` leaf lifts and ``(op, a_slot, b_slot, dst_slot)`` word ops —
    with stack-machine slot assignment (an n-ary node folds in place, so
    slot pressure is the tree's operand depth, not its width). Plans are
    hash-consed per structural tree, so equal shapes share one plan and one
    encoded tape.
  * **load**: each distinct leaf row is read once and lifted to its
    membership bitmap by kind;
  * **ops**: every interior node is an 8 kB word op between slots;
  * **root**: the root slot's popcount rides the same pass; the single
    best-of-three canonicalization happens once, outside, in
    ``torch_roaring._finalize_rows``.

``fused_eval_ref`` is the plain-torch version (same tape, batched lifts);
the CUDA kernel (``csrc/fused_eval.cu``) reads a program derived from the
tape as runtime data (``kernel_program`` / ``encode_program``), so one
compiled kernel serves every tree shape.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple, Union

import torch

from . import dispatch as D

ROW_WORDS = D.ROW_WORDS

__all__ = [
    "FusedPlan", "plan_tape", "plan_stats",
    "fused_eval_ref", "encode_tape", "TAPE_OPCODES",
    "kernel_program", "encode_program", "PROGRAM_PAD",
    "LIFT_META_FIELDS", "pack_lift_meta",
]

# A tree is an operand index (leaf) or an (op, *subtrees) tuple.
Tree = Union[int, Tuple]

_WORD_OPS = {
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "andnot": lambda a, b: a & ~b & 0xFFFF,
}

# opcode of each tape step in the encoded (int32) form the kernel reads
TAPE_OPCODES = {"load": 0, "and": 1, "or": 2, "andnot": 3}


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """A compiled expression shape: the op tape one fused launch replays
    per container column.

    ``tape`` steps are ``("load", operand_idx, dst_slot)`` or ``(op,
    a_slot, b_slot, dst_slot)`` with ``op`` in ``{"and", "or", "andnot"}``.
    The result lands in slot 0. ``n_slots`` is the peak scratch height;
    ``n_operands`` the number of distinct leaf rows.
    """

    tape: Tuple[Tuple, ...]
    n_slots: int
    n_operands: int

    @property
    def n_loads(self) -> int:
        return sum(1 for s in self.tape if s[0] == "load")

    @property
    def n_ops(self) -> int:
        return len(self.tape) - self.n_loads


def _emit(node: Tree, tape: list, height: int) -> int:
    """Post-order tape emission with stack-machine slot allocation: a node
    evaluates into slot ``height``; an n-ary node left-folds in place.
    Returns the peak slot count."""
    if isinstance(node, int):
        tape.append(("load", node, height))
        return height + 1
    op = node[0]
    if op not in _WORD_OPS:
        raise ValueError(f"unknown fused op {op!r}")
    children = node[1:]
    if op == "andnot" and len(children) != 2:
        raise ValueError("andnot is binary")
    if not children:
        raise ValueError(f"{op} node needs children")
    peak = _emit(children[0], tape, height)
    for ch in children[1:]:
        peak = max(peak, _emit(ch, tape, height + 1))
        tape.append((op, height, height + 1, height))
    return peak


@functools.lru_cache(maxsize=None)
def plan_tape(tree: Tree) -> FusedPlan:
    """Compile a structural expression tree (operand indices at the leaves,
    ``(op, *subtrees)`` tuples inside) into a ``FusedPlan``. Hash-consed:
    equal trees return the same plan object."""
    tape: list = []
    n_slots = _emit(tree, tape, 0)
    operands = {s[1] for s in tape if s[0] == "load"}
    n_operands = (max(operands) + 1) if operands else 0
    return FusedPlan(tuple(tape), n_slots, n_operands)


def plan_stats(plan: FusedPlan, n_containers: int) -> dict:
    """Launch-count / device-memory-traffic model for one plan over
    ``n_containers`` key-aligned columns — fused vs the per-op path (8 kB
    payload per container row; the i32 card adds 4 B)."""
    row = 2 * ROW_WORDS
    per_col_fused = plan.n_loads * row + row + 4
    per_col_per_op = plan.n_ops * (2 * row + row + 4)
    return {
        "n_operands": plan.n_operands,
        "n_combines": plan.n_ops,
        "launches_fused": 1,
        "launches_per_op": max(plan.n_ops, 1),
        "hbm_bytes_fused": per_col_fused * n_containers,
        "hbm_bytes_per_op": per_col_per_op * n_containers,
    }


@functools.lru_cache(maxsize=None)
def _tape_rows(plan: FusedPlan) -> Tuple[Tuple[int, int, int, int], ...]:
    rows = []
    for step in plan.tape:
        if step[0] == "load":
            _, n, dst = step
            rows.append((TAPE_OPCODES["load"], n, 0, dst))
        else:
            op, sa, sb, dst = step
            rows.append((TAPE_OPCODES[op], sa, sb, dst))
    return tuple(rows)


_TAPES: dict = {}


def encode_tape(plan: FusedPlan, device) -> torch.Tensor:
    """The plan's tape as i32[n_steps, 4] ``(opcode, a, b, dst)`` rows on
    ``device`` — a load is ``(0, operand, 0, dst)``. Cached per (plan,
    device), so a repeated query shape uploads nothing."""
    key = (plan, str(torch.device(device)))
    t = _TAPES.get(key)
    if t is None:
        t = torch.tensor(_tape_rows(plan), dtype=torch.int32,
                         device=device).reshape(-1, 4)
        _TAPES[key] = t
    return t


@functools.lru_cache(maxsize=None)
def kernel_program(plan: FusedPlan):
    """The CUDA kernel's program for ``plan``: ``(lifts, steps)``.

    ``lifts`` are the plan's distinct operands in the order of their first
    load; the kernel lifts each once per column, into row ``x`` for
    ``lifts[x]``. ``steps`` replay the tape over a stack whose top the
    kernel keeps in registers, one ``(code, idx)`` pair each, with ``code =
    op | from_row << 2 | (spill + 1) << 3`` and ``op`` the tape opcode:

      * load (op 0, from_row 1): spill the top to stack slot ``spill`` (-1:
        the stack is empty), then the top = lifted row ``idx``;
      * a load folded into the op that follows it (from_row 1): the top =
        top op lifted row ``idx``;
      * an op on a subtree's result (from_row 0): the top = stack slot
        ``idx`` op top.

    The root ends in the top. Raises ``ValueError`` for a tape that is not
    the stack program ``plan_tape`` emits."""
    lifts: list = []
    row_of: dict = {}
    steps: list = []
    tape, height, i = plan.tape, 0, 0
    while i < len(tape):
        step = tape[i]
        if step[0] == "load":
            _, n, dst = step
            if dst != height:
                raise ValueError(f"load into slot {dst} at height {height}")
            if n not in row_of:
                row_of[n] = len(lifts)
                lifts.append(n)
            nxt = tape[i + 1] if i + 1 < len(tape) else None
            if nxt is not None and nxt[0] != "load" and nxt[1:] == (
                    dst - 1, dst, dst - 1):
                steps.append((TAPE_OPCODES[nxt[0]] | 4, row_of[n]))
                i += 2
                continue
            steps.append((4 | (dst << 3), row_of[n]))      # spill dst - 1
            height += 1
        else:
            op, a, b, dst = step
            if (a, b, dst) != (height - 2, height - 1, height - 2):
                raise ValueError(f"op {step} at height {height}")
            steps.append((TAPE_OPCODES[op], a))
            height -= 1
        i += 1
    if height != 1:
        raise ValueError(f"the tape leaves {height} values, not one")
    return tuple(lifts), tuple(steps)


# step masks (c1, c2, c3) of the kernel's word op top = (top & c1) ^ (y &
# c2) ^ (top & y & c3), y the step's operand: per (op, from_row)
_STEP_MASKS = {(0, 1): 0b010,                       # load: y
               (1, 1): 0b100, (1, 0): 0b100,        # and
               (2, 1): 0b111, (2, 0): 0b111,        # or: t ^ y ^ ty
               (3, 1): 0b101,                       # top andnot row
               (3, 0): 0b110}                       # slot andnot top
PROGRAM_PAD = 2        # trailing steps the kernel prefetches but never runs

_PROGRAMS: dict = {}


def encode_program(plan: FusedPlan, part_vec: int, device):
    """``kernel_program(plan)`` as the kernel reads it, for rows of
    ``part_vec`` 16-byte vectors: ``(lifts i32[D], steps i32[P + 2,
    4])``. A step is ``(masks, operand, spill, 0)``: ``masks`` the bits
    (c1, c2, c3) of the word op ``top = (top & c1) ^ (y & c2) ^ (top & y
    & c3)`` with y the 16-byte vectors at byte offset ``operand``, and
    ``spill`` the byte offset the top is stored to first (-1: none).
    Offsets count from the block's scratch base, laid out as D tags of 16
    bytes, then the D lifted rows, then the stack rows. The last
    ``PROGRAM_PAD`` steps are padding the kernel loads ahead but never
    runs. Cached per (plan, part_vec, device)."""
    key = (plan, part_vec, str(torch.device(device)))
    t = _PROGRAMS.get(key)
    if t is None:
        lifts, steps = kernel_program(plan)
        n = len(lifts)

        def offset(from_row, idx):
            return 16 * (n + (idx if from_row else n + idx) * part_vec)

        rows = []
        for code, idx in steps:
            op, from_row, spill = code & 3, (code >> 2) & 1, (code >> 3) - 1
            rows.append((_STEP_MASKS[op, from_row], offset(from_row, idx),
                         offset(0, spill) if spill >= 0 else -1, 0))
        rows += [(0, 0, -1, 0)] * PROGRAM_PAD
        t = (torch.tensor(lifts, dtype=torch.int32, device=device),
             torch.tensor(rows, dtype=torch.int32, device=device))
        _PROGRAMS[key] = t
    return t


# =============================================================================
# meta packing (shared by both versions and the engine)
# =============================================================================

LIFT_META_FIELDS = 3  # (kind, card, n_runs) per (operand, column)


def pack_lift_meta(kind: torch.Tensor, card: torch.Tensor,
                   nruns: torch.Tensor) -> torch.Tensor:
    """Pack per-operand row tags + per-column live flags into the fused
    kernel's meta block.

    kind/card/nruns: i32[N, C]. Layout: interleaved (kind, card, n_runs) at
    flat index ``3 * (n * C + i)``, followed by C live flags (column ``i``
    is live iff any operand's row there is non-empty).
    """
    fields = torch.stack([kind, card, nruns], dim=2).reshape(-1)
    live = (kind != D.KIND_EMPTY).any(dim=0)
    return torch.cat([fields.to(torch.int32), live.to(torch.int32)])


# =============================================================================
# plain-torch evaluator (same tape, batched lifts)
# =============================================================================

_LIFTS = D.make_lift_kernels()


def fused_eval_ref(ops_data: torch.Tensor, meta: torch.Tensor, *,
                   plan: FusedPlan):
    """Plain-torch version of the fused kernel: the same tape, one batched
    lift per load (scatter-based coverage over just the rows of each kind),
    the same word ops over whole [C, 4096] slot arrays.

    ops_data: int16[N, C, 4096] raw container rows; meta: the
    ``pack_lift_meta`` block. Returns (bits int16[C, 4096] bitmap-domain
    root rows, card i32[C]); dead columns give zeros.
    """
    N, C = ops_data.shape[0], ops_data.shape[1]
    fields = meta[:LIFT_META_FIELDS * N * C].reshape(N, C, LIFT_META_FIELDS)
    kind, card, nruns = fields[..., 0], fields[..., 1], fields[..., 2]
    live = meta[LIFT_META_FIELDS * N * C:] != 0

    def load(n):
        bits = torch.zeros((C, ROW_WORDS), dtype=torch.int32,
                           device=ops_data.device)
        for k in (D.KIND_ARRAY, D.KIND_BITMAP, D.KIND_RUN):
            rows = torch.nonzero(kind[n] == k).flatten()
            if rows.numel():
                bits[rows] = _LIFTS[k](D.widen(ops_data[n, rows]),
                                       card[n, rows], nruns[n, rows])
        return bits

    slots = {}
    for step in plan.tape:
        if step[0] == "load":
            _, n, dst = step
            slots[dst] = load(n)
        else:
            op, sa, sb, dst = step
            slots[dst] = _WORD_OPS[op](slots[sa], slots[sb])
    res = slots[0] * live[:, None].to(torch.int32)
    card_out = D.popcount16(res).sum(dim=1, dtype=torch.int32)
    return D.narrow(res), card_out
