"""Dispatch-granularity fault injection for the Roaring query engine.

A ``FaultPlan`` counts every kernel launch on its target backend and raises
``InjectedFault`` on the chosen ones, through the ``kernels.roaring.ops``
fault hook, which fires before the launch. The engine's degradation ladder
drops a rung for ``InjectedFault`` and for nothing else: a real CUDA error
propagates, so a kernel that fails to build or launch fails the query.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["InjectedFault", "FaultPlan", "fault_scope"]


class InjectedFault(RuntimeError):
    """Raised by a ``FaultPlan`` in place of a device/runtime failure."""


@dataclasses.dataclass
class FaultPlan:
    """Injectable kernel-launch failures.

    ``fail_on`` names 0-based launch indices (on ``backend``) to fail;
    ``every`` fails each N-th launch instead; ``max_failures`` caps total
    injections (None = unlimited). ``dispatches``/``failures`` are live
    counters.
    """

    fail_on: frozenset = frozenset()
    every: Optional[int] = None
    backend: str = "cuda"
    max_failures: Optional[int] = None
    dispatches: int = 0
    failures: int = 0

    def on_dispatch(self, backend: str) -> None:
        """The ``kernels.roaring.ops`` fault-hook entry point."""
        if backend != self.backend:
            return
        i = self.dispatches
        self.dispatches += 1
        if self.max_failures is not None and self.failures >= self.max_failures:
            return
        hit = i in self.fail_on or (
            self.every is not None and (i + 1) % self.every == 0)
        if hit:
            self.failures += 1
            raise InjectedFault(
                f"injected {self.backend} fault at dispatch {i}")


class fault_scope:
    """Context manager installing a ``FaultPlan`` as the roaring dispatch
    fault hook; restores the previous hook on exit.

    >>> with fault_scope(FaultPlan(fail_on=frozenset({0}))):
    ...     out = index.execute(stack, expr, backend="cuda")
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._prev = None

    def __enter__(self) -> FaultPlan:
        from repro_torch.kernels.roaring import ops as _kops
        self._prev = _kops.set_fault_hook(self.plan.on_dispatch)
        return self.plan

    def __exit__(self, *exc) -> None:
        from repro_torch.kernels.roaring import ops as _kops
        _kops.set_fault_hook(self._prev)
