"""Fault tolerance: checkpoint / restart for training, and dispatch-
granularity fault injection for the Roaring query engine.

* ``ResilientTrainer`` wraps a train step with periodic async checkpoints
  and exception-triggered restore-and-retry. A CUDA error surfaces in
  PyTorch as a ``RuntimeError``, which it catches as the reference catches
  ``XlaRuntimeError``; every retry is counted in ``restarts``, so a caller
  that knows how many failures it injected can tell a real one apart.
* ``HeartbeatMonitor`` tracks per-step wall times; a step slower than
  ``factor`` x the rolling median is a straggler (recorded, or raised).
* ``simulate_failure`` is the injectable failure source for tests.

A ``FaultPlan`` counts every kernel launch on its target backend and raises
``InjectedFault`` on the chosen ones, through the ``kernels.roaring.ops``
fault hook, which fires before the launch. The engine's degradation ladder
drops a rung for ``InjectedFault`` and for nothing else: a real CUDA error
propagates, so a kernel that fails to build or launch fails the query.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint, save_checkpoint)

__all__ = ["StragglerPolicy", "HeartbeatMonitor", "ResilientTrainer",
           "simulate_failure", "InjectedFault", "FaultPlan", "fault_scope"]


@dataclasses.dataclass
class StragglerPolicy:
    factor: float = 2.0          # straggler = step_time > factor * median
    window: int = 32
    action: str = "record"       # "record" | "raise"


class HeartbeatMonitor:
    def __init__(self, policy: StragglerPolicy):
        self.policy = policy
        self.times: deque = deque(maxlen=policy.window)
        self.stragglers = 0
        self.last_heartbeat = time.monotonic()

    def beat(self, step_time: float) -> bool:
        """Record one step; returns True if it was a straggler."""
        self.last_heartbeat = time.monotonic()
        is_straggler = False
        if len(self.times) >= 8:
            med = float(np.median(self.times))
            if step_time > self.policy.factor * med:
                self.stragglers += 1
                is_straggler = True
                if self.policy.action == "raise":
                    raise RuntimeError(
                        f"straggler: {step_time:.3f}s vs median {med:.3f}s")
        self.times.append(step_time)
        return is_straggler


def _block_until_ready(tree) -> None:
    if any(isinstance(x, torch.Tensor) and x.is_cuda
           for x in _tree.leaves(tree)):
        torch.cuda.synchronize()


class ResilientTrainer:
    """Run a step function with checkpoint/restart fault tolerance."""

    def __init__(self, step_fn: Callable, ckpt_dir: str, *,
                 ckpt_every: int = 50, max_retries: int = 3,
                 policy: Optional[StragglerPolicy] = None,
                 failure_source: Optional[Callable[[int], None]] = None):
        self.step_fn = step_fn
        self.ckpt = AsyncCheckpointer(ckpt_dir)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.monitor = HeartbeatMonitor(policy or StragglerPolicy())
        self.failure_source = failure_source
        self.restarts = 0

    def run(self, state: Any, batches: Callable[[int], Any], n_steps: int,
            extra_state: Optional[dict] = None):
        """``batches(step)`` must be deterministic in step for exact replay.
        ``state`` is a train state (``train.TrainState``); the step function
        may update it in place, and a restore replaces it with new tensors
        read from the last checkpoint."""
        step = int(state["step"]) if "step" in state else 0
        extra_state = dict(extra_state or {})
        if latest_step(self.ckpt_dir) is None:
            # durable step-0 checkpoint: a failure before the first periodic
            # save must restore the *initial* state, not replay onto a
            # partially-trained one
            save_checkpoint(self.ckpt_dir, step, state, extra_state)
        while step < n_steps:
            try:
                if self.failure_source is not None:
                    self.failure_source(step)          # may raise (test hook)
                t0 = time.monotonic()
                state, metrics = self.step_fn(state, batches(step))
                _block_until_ready(state)
                self.monitor.beat(time.monotonic() - t0)
                step += 1
                if step % self.ckpt_every == 0:
                    extra_state["data_step"] = step
                    self.ckpt.save(step, state, extra_state)
            except RuntimeError:
                self.restarts += 1
                if self.restarts > self.max_retries:
                    raise
                self.ckpt.wait()
                state, extra_state, step = restore_checkpoint(
                    self.ckpt_dir, state)
        self.ckpt.wait()
        return state, extra_state


def simulate_failure(at_steps: set, exc: type = RuntimeError):
    """Failure source for tests: raise once at each given step."""
    fired = set()

    def src(step: int):
        if step in at_steps and step not in fired:
            fired.add(step)
            raise exc(f"injected failure at step {step}")
    return src


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
