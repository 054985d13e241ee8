"""Shared inputs for the reference-vs-port parity tests (``test_torch_*``).

Inputs are made from a seed with numpy and handed to both packages as numpy
arrays; outputs come back as numpy and are compared exactly.
"""

import numpy as np
import torch

from repro_torch.kernels.roaring.cases import (  # noqa: F401
    KIND_CASES, case_rows, container_row, pair_grid)


def to_t16(a):
    """numpy u16 -> torch int16 CPU tensor (same bytes)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint16).view(np.int16))


def to_np16(t):
    """torch int16 (u16 bit patterns) -> numpy u16."""
    return t.cpu().numpy().view(np.uint16)


def slab_leaves(s):
    """A reference ``repro.roaring.RoaringSlab`` -> dict of numpy leaves."""
    return {k: np.asarray(getattr(s, k))
            for k in ("keys", "kinds", "cards", "nruns", "payload")}


import gc  # noqa: E402
import sys  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def release_jax_executables():
    """Free every compiled XLA program of the worker when a module's tests
    start and again when they end.

    Every XLA:CPU executable holds memory maps, and a process may hold at
    most ``vm.max_map_count`` of them (65,530 by default); a test worker
    that passes that count segfaults in its next compile. The reference
    suite never frees its programs on this jaxlib, so a worker that picks
    up these modules late in a run may already hold tens of thousands of
    maps; the reference side of these parity tests compiles more. Importing
    the fixture into a test module turns it on there."""
    _clear()
    yield
    _clear()


def _clear():
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.clear_caches()
    gc.collect()


@pytest.fixture
def cuda():
    """Skip the requesting test unless a CUDA card is present (decided at
    run time, never at import, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip)")
    return torch.device("cuda")
