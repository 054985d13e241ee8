"""The batched wide-query executor: Boolean expression trees over stacked slabs.

Evaluates an expression tree whose leaves are members of a key-aligned
stacked ``repro_torch.roaring.RoaringSlab`` (``ndim == 2``) — or slabs
attached to the tree directly via ``leaf(slab)``:

  * every binary combine is one row-state step of ``torch_roaring``
    (``_and_rows`` through the dispatch kernel, ``_or_rows`` /
    ``_andnot_rows`` in plain torch);
  * n-ary AND/OR nodes reduce in log depth;
  * canonicalization (best-of-three) is deferred to a single
    ``_finalize_rows`` at the root;
  * ``fused=True`` evaluates the whole tree in ONE ``fused_tree`` launch,
    with the per-op path as the next rung of the degradation ladder;
  * ``batched_and_card`` / ``topk_by_card`` score all N stacked slabs
    against one query in a single stacked dispatch launch; their
    ``_sharded`` forms score each rank's rows of a stack sharded over a
    ``DeviceMesh`` dimension and all-gather the scores.

The ladder (``_run_ladder``) drops a rung only for ``InjectedFault`` — the
fault plan's exception. Any other error propagates, so on the card a kernel
that fails to build or launch fails the query instead of hiding behind a
lower rung. The plain-torch rung exists only for CPU tensors.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple, Union

import torch

import repro_torch.obs as obs
from repro_torch.core import torch_roaring as tr
from repro_torch.kernels.roaring import fused as _fused
from repro_torch.kernels.roaring import ops as _kops
from repro_torch.roaring.slab import RoaringSlab, SlabLike, _to_internal, _wrap
from repro_torch.runtime.fault_tolerance import InjectedFault

__all__ = [
    "Expr", "Leaf", "SlabLeaf", "And", "Or", "AndNot",
    "leaf", "and_", "or_", "andnot",
    "CompiledQuery", "compile_query",
    "execute", "execute_card", "wide_union", "wide_intersect",
    "batched_and_card", "batched_and_card_sharded", "topk_by_card",
    "topk_by_card_sharded", "union_many_batched", "launch_model",
]


# =============================================================================
# expression trees
# =============================================================================

@dataclasses.dataclass(frozen=True)
class Expr:
    """Base class for wide Boolean query expressions (static structure)."""


@dataclasses.dataclass(frozen=True)
class Leaf(Expr):
    """Member ``i`` of the stacked slab."""

    i: int


@dataclasses.dataclass(frozen=True, eq=False)
class SlabLeaf(Expr):
    """A ``RoaringSlab`` operand attached to the tree directly — its rows
    are gathered key-aligned to the query's shared key row."""

    slab: SlabLike


@dataclasses.dataclass(frozen=True)
class And(Expr):
    """N-ary intersection of child expressions (log-depth reduction)."""

    children: Tuple[Expr, ...]


@dataclasses.dataclass(frozen=True)
class Or(Expr):
    """N-ary union of child expressions (log-depth reduction)."""

    children: Tuple[Expr, ...]


@dataclasses.dataclass(frozen=True)
class AndNot(Expr):
    """Difference ``a \\ b``."""

    a: Expr
    b: Expr


def leaf(x: Union[int, SlabLike]) -> Expr:
    """Leaf node: an ``int`` selects member ``x`` of the stacked slab; a
    ``RoaringSlab`` becomes its own operand (``SlabLeaf``)."""
    if isinstance(x, (RoaringSlab, tr.RoaringSlab)):
        if isinstance(x, RoaringSlab) and x.ndim != 1:
            raise ValueError("leaf(slab) needs a single slab (ndim == 1)")
        return SlabLeaf(x)
    if int(x) < 0:
        raise ValueError(f"leaf index must be >= 0, got {x}")
    return Leaf(int(x))


def and_(*children: Expr) -> Expr:
    """N-ary AND node (``and_(x)`` collapses to ``x``)."""
    if not children:
        raise ValueError("and_() needs at least one child expression")
    return children[0] if len(children) == 1 else And(tuple(children))


def or_(*children: Expr) -> Expr:
    """N-ary OR node (``or_(x)`` collapses to ``x``)."""
    if not children:
        raise ValueError("or_() needs at least one child expression")
    return children[0] if len(children) == 1 else Or(tuple(children))


def andnot(a: Expr, b: Expr) -> AndNot:
    """Difference node ``a \\ b``."""
    return AndNot(a, b)


# =============================================================================
# per-op evaluation (row states: (data int16[C, 4096], card, kind))
# =============================================================================

def _slab_leaves(expr: Expr) -> list:
    if isinstance(expr, SlabLeaf):
        return [expr.slab]
    if isinstance(expr, (And, Or)):
        return [s for c in expr.children for s in _slab_leaves(c)]
    if isinstance(expr, AndNot):
        return _slab_leaves(expr.a) + _slab_leaves(expr.b)
    return []


def _shared_keys(stack: Optional[RoaringSlab], expr: Expr,
                 capacity: Optional[int]) -> torch.Tensor:
    """The key row every leaf aligns to: the stack's key row when a stack
    is given, else the merged key set of all slab leaves."""
    if stack is not None:
        return stack.keys[0]
    slabs = [_to_internal(s) for s in _slab_leaves(expr)]
    if not slabs:
        raise ValueError("execute(stack=None, ...) needs slab leaves")
    if capacity is None:
        capacity = sum(s.keys.shape[-1] for s in slabs)
    return tr._merge_keys_many([s.keys for s in slabs], capacity)


def _check_leaf(stack: Optional[RoaringSlab], i: int) -> None:
    if stack is None:
        raise ValueError(f"leaf({i}) needs a stacked slab; this expression "
                         "was executed without one")
    if not 0 <= i < stack.n_slabs:
        raise IndexError(
            f"leaf({i}) out of range for a stack of {stack.n_slabs} slabs")


def _leaf_state(stack: Optional[RoaringSlab], i: int):
    _check_leaf(stack, i)
    return stack.payload[i], stack.cards[i], stack.kinds[i]


def _fold_states(states, combine):
    """Balanced pairwise fold (log depth) over already-evaluated states."""
    states = list(states)
    while len(states) > 1:
        nxt = []
        for i in range(0, len(states) - 1, 2):
            a, b = states[i], states[i + 1]
            nxt.append(combine(a[0], a[1], a[2], b[0], b[1], b[2]))
        if len(states) % 2:
            nxt.append(states[-1])
        states = nxt
    return states[0]


def _nary(stack, keys, children, combine):
    if stack is not None and all(isinstance(c, Leaf) for c in children):
        # slice the stacked leaf axis and tree-reduce flat: every level is
        # ONE combine over (n/2)*C rows
        for c in children:
            _check_leaf(stack, c.i)
        with obs.span("device.wait"):     # a pageable upload waits
            idx = torch.tensor([c.i for c in children], device=stack.device)
        return tr._tree_reduce_rows(stack.payload[idx], stack.cards[idx],
                                    stack.kinds[idx], combine)
    return _fold_states([_eval(stack, keys, c) for c in children], combine)


def _eval(stack, keys, expr: Expr):
    if isinstance(expr, Leaf):
        return _leaf_state(stack, expr.i)
    if isinstance(expr, SlabLeaf):
        return tr._gather_raw(_to_internal(expr.slab), keys)
    if isinstance(expr, And):
        return _nary(stack, keys, expr.children, tr._and_rows)
    if isinstance(expr, Or):
        return _nary(stack, keys, expr.children, tr._or_rows)
    if isinstance(expr, AndNot):
        a = _eval(stack, keys, expr.a)
        b = _eval(stack, keys, expr.b)
        return tr._andnot_rows(a[0], a[1], a[2], b[0], b[1], b[2])
    raise TypeError(f"not an Expr: {expr!r}")


def _normalize(stack, expr):
    """Allow ``execute(expr)`` when every leaf carries its own slab."""
    if isinstance(stack, Expr) and expr is None:
        return None, stack
    if expr is None:
        raise TypeError("execute needs an expression")
    return stack, expr


# =============================================================================
# fused evaluation: the whole tree in ONE launch
# =============================================================================

def _lower_tree(expr: Expr) -> tuple:
    """``(tree, order)``: ``tree`` is the hash-consable structure with
    distinct leaves replaced by dense operand indices, ``order`` the
    deduplicated leaf list — a leaf referenced twice is read once."""
    order: list = []
    index_of: dict = {}

    def visit(e):
        if isinstance(e, Leaf):
            key = ("leaf", e.i)
        elif isinstance(e, SlabLeaf):
            key = ("slab", id(e.slab))
        elif isinstance(e, And):
            return ("and",) + tuple(visit(c) for c in e.children)
        elif isinstance(e, Or):
            return ("or",) + tuple(visit(c) for c in e.children)
        elif isinstance(e, AndNot):
            return ("andnot", visit(e.a), visit(e.b))
        else:
            raise TypeError(f"not an Expr: {e!r}")
        if key not in index_of:
            index_of[key] = len(order)
            order.append(e)
        return index_of[key]

    return visit(expr), order


def launch_model(expr: Expr, *, stacked: bool = True) -> dict:
    """Analytic kernel-launch accounting for one expression.

    ``per_op_combines`` is the logical combine count (N-1 for an N-leaf
    tree). ``per_op_dispatches`` is what the per-op engine launches through
    ``ops.intersect_dispatch``: AND combines over all-``Leaf`` children
    batch into a log-depth tree reduce (``ceil(log2 n)`` launches when
    ``stacked``), mixed-children ANDs fold pairwise (n-1 launches), and
    OR/ANDNOT combines are plain torch — zero launches. ``fused_launches``
    is always 1.
    """
    tree, order = _lower_tree(expr)
    plan = _fused.plan_tape(tree)

    def dispatches(e) -> int:
        if isinstance(e, (Leaf, SlabLeaf)):
            return 0
        if isinstance(e, And):
            n = len(e.children)
            if stacked and all(isinstance(c, Leaf) for c in e.children):
                return (n - 1).bit_length()
            return (n - 1) + sum(dispatches(c) for c in e.children)
        if isinstance(e, Or):
            return sum(dispatches(c) for c in e.children)
        if isinstance(e, AndNot):
            return dispatches(e.a) + dispatches(e.b)
        raise TypeError(f"not an Expr: {e!r}")

    return {
        "n_operands": len(order),
        "per_op_combines": int(plan.n_ops),
        "per_op_dispatches": dispatches(expr),
        "fused_launches": 1,
    }


def _fused_lower(expr: Expr):
    """Lower an ``Expr`` for the fused evaluator: the ``FusedPlan`` and the
    distinct operand expressions in the plan's operand order."""
    tree, order = _lower_tree(expr)
    return _fused.plan_tape(tree), tuple(order)


def _fused_gather(stack, keys, order):
    """The fused evaluator's operand rows int16[N, C, 4096] and packed lift
    meta for the lowered operands ``order``. When the operands are exactly
    the stack's members in order (what the search service builds), the
    stack's tensors are used without a copy."""
    if stack is not None and all(isinstance(e, Leaf) for e in order):
        idx = [e.i for e in order]
        for i in idx:
            _check_leaf(stack, i)
        if idx == list(range(stack.n_slabs)):
            data, kind, card, nruns = (stack.payload, stack.kinds,
                                       stack.cards, stack.nruns)
        else:
            with obs.span("device.wait"):     # a pageable upload waits
                t = torch.tensor(idx, device=stack.device)
            data, kind, card, nruns = (stack.payload[t], stack.kinds[t],
                                       stack.cards[t], stack.nruns[t])
    else:
        states = []
        for e in order:
            if isinstance(e, Leaf):
                d, c, k = _leaf_state(stack, e.i)
                r = stack.nruns[e.i]
            else:
                d, c, k = tr._gather_raw(_to_internal(e.slab), keys)
                r = tr._rows_nruns(d, k)
            states.append((d, c, k, r))
        data = torch.stack([s[0] for s in states])
        card = torch.stack([s[1] for s in states])
        kind = torch.stack([s[2] for s in states])
        nruns = torch.stack([s[3] for s in states])
    return data.contiguous(), _fused.pack_lift_meta(kind, card, nruns)


def _fused_eval(stack, keys, expr: Expr, lowered=None):
    """Row-state result of the fused path: one ``ops.fused_tree`` launch,
    root rows in bitmap domain (kind from the fused per-column card).
    ``lowered`` is ``_fused_lower``'s output when compiled ahead; the
    operand rows are gathered on every call."""
    plan, order = lowered or _fused_lower(expr)
    with obs.span("index.gather"):
        data, meta = _fused_gather(stack, keys, order)
    bits, card = _kops.fused_tree(data, meta, plan)
    live = card > 0
    kind = torch.where(live, tr.KIND_BITMAP, tr.KIND_EMPTY).to(torch.int32)
    # empty rows carry the packed-array padding fill (0xFFFF), matching the
    # per-op pipeline's convention for dead payloads
    bits = torch.where(live[:, None], bits, torch.full_like(bits, -1))
    return bits, card, kind


@dataclasses.dataclass(frozen=True, eq=False)
class CompiledQuery:
    """An expression lowered once for repeated runs over one stack: the
    shared key row and, for the fused path, the ``FusedPlan`` with its
    operand order. It holds no operand rows: each run gathers them from the
    stack, so a kept plan costs no device memory beyond the key row. The
    stack must not change while the compiled query is in use."""

    expr: Expr
    keys: torch.Tensor
    fused_lowered: Optional[tuple]


def compile_query(stack: Optional[RoaringSlab], expr: Expr,
                  capacity: Optional[int] = None, *,
                  fused: bool = False) -> CompiledQuery:
    """Lower ``expr`` over ``stack`` for ``execute(..., compiled=)`` /
    ``execute_card(..., compiled=)``."""
    return CompiledQuery(expr, _shared_keys(stack, expr, capacity),
                         _fused_lower(expr) if fused else None)


# =============================================================================
# graceful degradation: the rung ladder
# =============================================================================

# the only failure the ladder absorbs: a fault plan's injected fault
_FALLBACK_ERRORS = (InjectedFault,)


def _run_ladder(rungs, max_retries: int, backoff_s: float):
    """Run the first workable rung of ``rungs``: ordered ``(backend, kind,
    fn)`` triples, most-preferred first (``kind`` is ``"fused"`` /
    ``"per_op"``).

    The first rung gets ``max_retries`` retries with exponential backoff;
    later rungs get one attempt each. Every failed attempt counts in
    ``index.dispatch_failures``; every rung drop in ``index.fallbacks``; the
    winning rung in ``index.rung_taken{kind,backend}``. Each attempt runs
    under an ``index.rung`` span. A failure on the last rung propagates.
    """
    reg = obs.registry()
    for r, (rung_backend, rung_kind, fn) in enumerate(rungs):
        tries = (max_retries + 1) if r == 0 else 1
        for attempt in range(tries):
            try:
                with obs.span("index.rung"):
                    with _kops.backend_scope(rung_backend):
                        out = fn()
                reg.counter("index.rung_taken", kind=rung_kind,
                            backend=rung_backend).inc()
                return out
            except _FALLBACK_ERRORS:
                if r == len(rungs) - 1 and attempt == tries - 1:
                    raise
                reg.counter("index.dispatch_failures").inc()
                if attempt < tries - 1:
                    reg.counter("index.retries").inc()
                    if backoff_s > 0:
                        time.sleep(backoff_s * (2 ** attempt))
        reg.counter("index.fallbacks").inc()


def _run_query(fused_fn, per_op_fn, fused: bool, backend: Optional[str],
               max_retries: int, backoff_s: float, device):
    """Ladder for one query: preferred-backend fused (when ``fused``) ->
    preferred-backend per-op -> plain-torch per-op, the last only for CPU
    tensors (the plain versions never run on the card). A query on the
    ``"torch"`` backend runs its one rung directly."""
    preferred = backend or _kops.current_backend(device)
    if preferred == "torch" and not fused:
        with obs.span("index.rung"):
            with _kops.backend_scope("torch"):
                out = per_op_fn()
        obs.registry().counter("index.rung_taken", kind="per_op",
                               backend="torch").inc()
        return out
    rungs = [(preferred, "per_op", per_op_fn)]
    if fused:
        rungs.insert(0, (preferred, "fused", fused_fn))
    if preferred != "torch" and torch.device(device).type == "cpu":
        rungs.append(("torch", "per_op", per_op_fn))
    return _run_ladder(rungs, max_retries, backoff_s)


def _prepare(stack, expr, capacity, compiled: Optional[CompiledQuery]):
    """(stack, expr, keys, fused lowering or None) of one query."""
    if compiled is not None:
        return stack, compiled.expr, compiled.keys, compiled.fused_lowered
    stack, expr = _normalize(stack, expr)
    return stack, expr, _shared_keys(stack, expr, capacity), None


def execute(stack: Optional[RoaringSlab], expr: Optional[Expr] = None,
            capacity: Optional[int] = None, *, fused: bool = False,
            backend: Optional[str] = None, max_retries: int = 1,
            backoff_s: float = 0.0,
            compiled: Optional[CompiledQuery] = None) -> RoaringSlab:
    """Evaluate ``expr`` over the stacked slab -> canonical ``RoaringSlab``.

    One deferred best-of-three canonicalization at the root; output is
    byte-identical to the reference engine's. ``stack`` may be ``None``
    when every leaf is a ``leaf(slab)``. ``fused=True`` evaluates the whole
    tree in one kernel launch, with the per-op path as the next rung.
    ``backend`` is ``"cuda"`` / ``"torch"`` / None (the data's own).
    ``compiled`` (from ``compile_query``) replaces ``expr`` and skips the
    lowering.
    """
    stack, expr, keys, lowered = _prepare(stack, expr, capacity, compiled)

    def finalize(data, card, kind) -> RoaringSlab:
        with obs.span("index.finalize"):
            return _wrap(tr._finalize_rows(keys, data, card, kind))

    def per_op() -> RoaringSlab:
        return finalize(*_eval(stack, keys, expr))

    def fused_attempt() -> RoaringSlab:
        return finalize(*_fused_eval(stack, keys, expr, lowered))

    with obs.span("index.execute"):
        return _run_query(fused_attempt, per_op, fused, backend, max_retries,
                          backoff_s, keys.device)


def execute_card(stack: Optional[RoaringSlab],
                 expr: Optional[Expr] = None,
                 capacity: Optional[int] = None, *, fused: bool = False,
                 backend: Optional[str] = None, max_retries: int = 1,
                 backoff_s: float = 0.0,
                 compiled: Optional[CompiledQuery] = None) -> torch.Tensor:
    """|expr| without materializing a result slab (the root's counter sum;
    ``fused=True`` takes it from the fused kernel's root popcount). Runs
    the same degradation ladder as ``execute``."""
    stack, expr, keys, lowered = _prepare(stack, expr, capacity, compiled)

    def per_op() -> torch.Tensor:
        _, card, _ = _eval(stack, keys, expr)
        return card.sum(dtype=torch.int64)

    def fused_attempt() -> torch.Tensor:
        _, card, _ = _fused_eval(stack, keys, expr, lowered)
        return card.sum(dtype=torch.int64)

    with obs.span("index.execute_card"):
        return _run_query(fused_attempt, per_op, fused, backend, max_retries,
                          backoff_s, keys.device)


def wide_union(stack: RoaringSlab) -> RoaringSlab:
    """Union of all N stacked slabs (Algorithm 4): log-depth tree reduction,
    kind-dispatching at every level, deferred cardinality (one recount at
    the root), single deferred canonicalization."""
    data, card, kind = tr._tree_reduce_rows(stack.payload, stack.cards,
                                            stack.kinds, tr._or_rows_deferred)
    card = tr._recount_bitmap_rows(data, card, kind)
    return _wrap(tr._finalize_rows(stack.keys[0], data, card, kind))


def wide_intersect(stack: RoaringSlab) -> RoaringSlab:
    """Intersection of all N stacked slabs: log-depth tree of dispatch
    steps (one ``intersect_dispatch`` launch per level), single deferred
    canonicalization."""
    data, card, kind = tr._tree_reduce_rows(stack.payload, stack.cards,
                                            stack.kinds, tr._and_rows)
    return _wrap(tr._finalize_rows(stack.keys[0], data, card, kind))


def union_many_batched(slabs, capacity: int) -> RoaringSlab:
    """Deprecated: use ``repro_torch.roaring.union_all`` (the same
    reduction, per member of equal-batch stacked slabs)."""
    import warnings

    from repro_torch.roaring.slab import union_all
    warnings.warn(
        "repro_torch.index.union_many_batched is deprecated; use "
        "repro_torch.roaring.union_all(slabs, capacity=...)",
        DeprecationWarning, stacklevel=2)
    return union_all(slabs, capacity=capacity)


# =============================================================================
# batched scoring: all N slabs against one query in one dispatch launch
# =============================================================================

def _align_query(stack: RoaringSlab, query: SlabLike):
    """Gather the query's rows aligned to the stack's key row."""
    qd, qc, qk = tr._gather_raw(_to_internal(query), stack.keys[0])
    return qd, qc, qk, tr._rows_nruns(qd, qk)


def _stack_scores(data, card, kind, nruns, qd, qc, qk, qr):
    """Per-slab |slab_n ∩ query| via one card-only stacked launch that reads
    the query's C rows once (no N-times broadcast, no hits written)."""
    N, C = kind.shape
    meta = torch.stack([
        kind, qk.expand(N, C), card, qc.expand(N, C),
        nruns, qr.expand(N, C)], dim=2).reshape(N, 6 * C).to(torch.int32)
    rc = _kops.stacked_and_card(data, qd.contiguous(), meta)
    return rc.sum(dim=1, dtype=torch.int32)


def batched_and_card(stack: RoaringSlab, query: SlabLike) -> torch.Tensor:
    """i32[N] of |slab_n ∩ query| — one stacked dispatch launch covers all
    N*C container pairs; nothing is materialized or canonicalized."""
    with obs.span("index.score"):
        qd, qc, qk, qr = _align_query(stack, query)
        return _stack_scores(stack.payload, stack.cards, stack.kinds,
                             stack.nruns, qd, qc, qk, qr)


def topk_by_card(stack: RoaringSlab, query: SlabLike, k: int):
    """Top-k stacked slabs by intersection cardinality with ``query``:
    ``(scores i32[k], indices i32[k])``, highest score first and, among
    equal scores, the lower index first."""
    return _topk_scores(batched_and_card(stack, query), k)


def _topk_scores(scores: torch.Tensor, k: int):
    order = torch.sort(scores, descending=True, stable=True)
    return order.values[:k], order.indices[:k].to(torch.int32)


# =============================================================================
# sharding: slab axis across the ranks of a mesh dimension, query replicated
# =============================================================================

def _local(x):
    """A DTensor's local shard (a plain tensor as it is)."""
    return x.to_local() if hasattr(x, "to_local") else x


def batched_and_card_sharded(stack: RoaringSlab, query: SlabLike,
                             mesh, axis: str = "data") -> torch.Tensor:
    """``batched_and_card`` with the slab axis sharded over ``mesh[axis]``
    (``distributed.sharding.shard_postings``).

    Each rank scores its own rows against the replicated query with one
    stacked launch and the i32 scores are all-gathered in rank order over
    the axis's process group; no slab payload crosses ranks. The stack's
    row count must divide evenly by the axis size. Returns i32[N], the
    same on every rank.
    """
    import torch.distributed as dist

    local = RoaringSlab(keys=_local(stack.keys), kinds=_local(stack.kinds),
                        cards=_local(stack.cards), nruns=_local(stack.nruns),
                        payload=_local(stack.payload), C=stack.C)
    scores = batched_and_card(local, query)
    group = mesh.get_group(axis)
    parts = [torch.empty_like(scores)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, scores, group=group)
    return torch.cat(parts)


def topk_by_card_sharded(stack: RoaringSlab, query: SlabLike, k: int,
                         mesh, axis: str = "data"):
    """Sharded ``topk_by_card``: local scoring per rank, then the same
    stable top-k over the gathered i32[N] scores (ties keep the lower
    index first), so the result equals the unsharded one."""
    return _topk_scores(
        batched_and_card_sharded(stack, query, mesh, axis=axis), k)
