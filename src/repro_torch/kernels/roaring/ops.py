"""Entry points for the Roaring container kernels.

Each entry point runs the hand-written CUDA kernel for CUDA tensors and its
plain-torch version for CPU tensors — the tensor's device decides, nothing
else. A CUDA tensor never reaches a plain version: under
``backend_scope("torch")`` a CUDA launch raises.

Per-launch controls, as in the reference package:

* ``backend_scope("cuda" | "torch" | "auto")`` names the backend every
  launch inside the ``with`` block reports; ``repro_torch.index`` runs its
  degradation ladder with it. ``"auto"`` reports the tensor's own backend.
* ``set_fault_hook(fn)`` installs a callable invoked with the backend name
  before every launch — the seam ``runtime.fault_tolerance.FaultPlan`` plugs
  into.
* ``add_launch_hook(fn)`` / ``remove_launch_hook(fn)`` subscribe observers
  to every launch as a ``LaunchEvent(entry, backend)``. Launch hooks fire
  before the fault hook, so a launch the fault plan then fails still counts.
  Launch hooks must not raise; an exception from one is swallowed.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Tuple

import torch

from . import fused as _f
from . import kernel as _k
from . import ref as _ref

__all__ = ["LaunchEvent", "add_launch_hook", "remove_launch_hook",
           "backend_scope", "current_backend", "set_fault_hook",
           "intersect_dispatch", "intersect_dispatch_stacked",
           "stacked_and_card", "fused_tree", "container_op",
           "array_intersect", "BACKENDS"]

BACKENDS = ("cuda", "torch")

_BACKEND_OVERRIDE: Optional[str] = None       # None == "auto"
_FAULT_HOOK: Optional[Callable[[str], None]] = None
_LAUNCH_HOOKS: Tuple[Callable[["LaunchEvent"], None], ...] = ()


@dataclasses.dataclass(frozen=True)
class LaunchEvent:
    """One kernel launch: the public entry point and the backend it
    resolved to (``"cuda"`` / ``"torch"``)."""

    entry: str
    backend: str


def add_launch_hook(hook: Callable[[LaunchEvent], None]) -> None:
    """Subscribe an observer to every kernel launch. Idempotent."""
    global _LAUNCH_HOOKS
    if hook not in _LAUNCH_HOOKS:
        _LAUNCH_HOOKS = _LAUNCH_HOOKS + (hook,)


def remove_launch_hook(hook: Callable[[LaunchEvent], None]) -> None:
    """Unsubscribe a launch observer (no-op if absent)."""
    global _LAUNCH_HOOKS
    _LAUNCH_HOOKS = tuple(h for h in _LAUNCH_HOOKS if h != hook)


@contextlib.contextmanager
def backend_scope(backend: Optional[str]):
    """Scoped backend override: ``"cuda"``, ``"torch"``, or
    ``"auto"``/``None`` (the tensor's own backend). Nests; restores the
    previous override on exit."""
    global _BACKEND_OVERRIDE
    if backend not in (None, "auto") + BACKENDS:
        raise ValueError(f"unknown roaring backend {backend!r} "
                         "(want 'cuda', 'torch', or 'auto')")
    prev = _BACKEND_OVERRIDE
    _BACKEND_OVERRIDE = None if backend == "auto" else backend
    try:
        yield
    finally:
        _BACKEND_OVERRIDE = prev


def current_backend(device=None) -> str:
    """The backend a launch on ``device`` would report right now (the
    default device is the card when there is one)."""
    if _BACKEND_OVERRIDE is not None:
        return _BACKEND_OVERRIDE
    if device is None:
        return "cuda" if torch.cuda.is_available() else "torch"
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def set_fault_hook(hook: Optional[Callable[[str], None]]):
    """Install (or clear, with ``None``) the per-launch fault hook; returns
    the previous hook."""
    global _FAULT_HOOK
    prev = _FAULT_HOOK
    _FAULT_HOOK = hook
    return prev


def _resolve(entry: str, t: torch.Tensor) -> str:
    """Resolve the backend of one launch on tensor ``t``, then fire the
    launch hooks (accounting) and the fault hook (injection), in that
    order."""
    backend = current_backend(t.device)
    if t.is_cuda and backend != "cuda":
        raise ValueError(f"{entry}: the plain {backend!r} version runs only "
                         "on CPU tensors")
    if _LAUNCH_HOOKS:
        ev = LaunchEvent(entry, backend)
        for hook in _LAUNCH_HOOKS:
            try:
                hook(ev)
            except Exception:
                pass
    if _FAULT_HOOK is not None:
        _FAULT_HOOK(backend)
    return backend


def container_op(a_bits: torch.Tensor, b_bits: torch.Tensor,
                 kinds: torch.Tensor, op: str = "or"):
    """Batched word op (``"and"`` / ``"or"`` / ``"xor"`` / ``"andnot"``) +
    popcount over key-aligned bitmap-domain rows.

    a_bits, b_bits: int16[C, 4096]; kinds: i32[2C] interleaved (kind_a,
    kind_b). Returns (out int16[C, 4096], card i32[C]); both-EMPTY pairs
    give zeros and card 0.
    """
    _resolve("container_op", a_bits)
    if a_bits.is_cuda:
        return _k.container_op_cuda(a_bits.contiguous(), b_bits.contiguous(),
                                    kinds.to(torch.int32).contiguous(), op)
    return _ref.container_op_ref(a_bits, b_bits, kinds, op)


def array_intersect(a_arr: torch.Tensor, b_arr: torch.Tensor,
                    cards: torch.Tensor):
    """Batched packed-array intersection (each of A's values searches B).

    a_arr, b_arr: int16[C, 4096] packed sorted arrays, 0xFFFF padded;
    cards: i32[2C] interleaved (card_a, card_b). Returns (hits int16[C,
    4096] — 1 where a value of A is also in B — and count i32[C]).
    """
    _resolve("array_intersect", a_arr)
    if a_arr.is_cuda:
        return _k.array_intersect_cuda(a_arr.contiguous(),
                                       b_arr.contiguous(),
                                       cards.to(torch.int32).contiguous())
    return _ref.array_intersect_ref(a_arr, b_arr, cards)


def intersect_dispatch(a_data: torch.Tensor, b_data: torch.Tensor,
                       meta: torch.Tensor):
    """Kind-dispatch container intersection over key-aligned rows, routed
    by ``dispatch.AND_TABLE``.

    a_data, b_data: int16[C, 4096] raw rows; meta: i32[6C] interleaved
    (kind_a, kind_b, card_a, card_b, nruns_a, nruns_b). Returns
    (hits int16[C, 4096], card i32[C]).
    """
    _resolve("intersect_dispatch", a_data)
    if a_data.is_cuda:
        return _k.intersect_dispatch_cuda(a_data.contiguous(),
                                          b_data.contiguous(),
                                          meta.contiguous())
    return _ref.intersect_dispatch_ref(a_data, b_data, meta)


def intersect_dispatch_stacked(a_data: torch.Tensor, b_data: torch.Tensor,
                               meta: torch.Tensor):
    """N key-aligned slabs of C rows each in one launch.

    a_data, b_data: int16[N, C, 4096]; meta: i32[N, 6C]. Returns
    (hits int16[N, C, 4096], card i32[N, C]).
    """
    _resolve("intersect_dispatch_stacked", a_data)
    N, C, W = a_data.shape
    a2 = a_data.reshape(N * C, W).contiguous()
    b2 = b_data.reshape(N * C, W).contiguous()
    if a_data.is_cuda:
        hits, card = _k.intersect_dispatch_cuda(
            a2, b2, meta.reshape(-1).contiguous(),
            entry="intersect_dispatch_stacked")
    else:
        hits, card = _ref.intersect_dispatch_ref(a2, b2, meta.reshape(-1))
    return hits.reshape(N, C, W), card.reshape(N, C)


def stacked_and_card(a_data: torch.Tensor, query: torch.Tensor,
                     meta: torch.Tensor) -> torch.Tensor:
    """Card-only stacked intersection against one shared query: a_data
    int16[N, C, 4096], query int16[C, 4096] (read once per pair, never
    broadcast), meta i32[N, 6C]. Returns card i32[N, C]. Reports as the
    ``intersect_dispatch_stacked`` entry."""
    _resolve("intersect_dispatch_stacked", a_data)
    N, C, W = a_data.shape
    if a_data.is_cuda:
        _, card = _k.intersect_dispatch_cuda(
            a_data.reshape(N * C, W).contiguous(), query.contiguous(),
            meta.reshape(-1).contiguous(),
            entry="intersect_dispatch_stacked", want_hits=False)
    else:
        _, card = _ref.intersect_dispatch_ref(
            a_data.reshape(N * C, W),
            query.expand(N, C, W).reshape(N * C, W), meta.reshape(-1))
    return card.reshape(N, C)


def fused_tree(ops_data: torch.Tensor, meta: torch.Tensor,
               plan: _f.FusedPlan):
    """Evaluate a whole compiled Boolean tree in one launch.

    ops_data: int16[N, C, 4096] raw rows (one per distinct leaf, key
    aligned); meta: the ``fused.pack_lift_meta`` block; plan: a
    ``fused.FusedPlan``. Returns (bits int16[C, 4096] bitmap-domain root
    rows, card i32[C]); the caller runs the single canonicalization.
    """
    _resolve("fused_tree", ops_data)
    if ops_data.is_cuda:
        return _k.fused_eval_cuda(ops_data.contiguous(), meta.contiguous(),
                                  plan)
    return _f.fused_eval_ref(ops_data, meta, plan=plan)
