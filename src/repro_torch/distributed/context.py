"""The launcher's declared mesh: data axes, the model axis and the mesh.

The reference declares the data-parallel mesh axes once so that the model
body can pin its per-layer activations for XLA's sharding propagation. The
port's launcher declares its ``torch.distributed.device_mesh.DeviceMesh``
the same way (``data_axes(..., mesh=mesh)``). Eager PyTorch has no sharding
propagation to anchor, so ``constrain_batch`` / ``constrain`` return a plain
tensor as it is and redistribute a DTensor to the asked placements.
Collectives over one mesh dimension (``grad_comp.compressed_crosspod_mean``)
take that dimension's process group from the declared mesh
(``axis_group``), where the reference names an axis bound by ``shard_map``.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

_DATA_AXES: Optional[tuple] = None
_DATA_COUNT: int = 1
_MODEL_AXIS: Optional[str] = None
_MESH = None


@contextlib.contextmanager
def data_axes(axes: Sequence[str], count: int = 1,
              model_axis: Optional[str] = "model", mesh=None):
    """Declare the mesh axes carrying the batch dim, their total size, the
    model axis and the ``DeviceMesh`` whose dimensions they name."""
    global _DATA_AXES, _DATA_COUNT, _MODEL_AXIS, _MESH
    prev = (_DATA_AXES, _DATA_COUNT, _MODEL_AXIS, _MESH)
    _DATA_AXES, _DATA_COUNT, _MODEL_AXIS = tuple(axes), int(count), model_axis
    _MESH = mesh
    try:
        yield
    finally:
        _DATA_AXES, _DATA_COUNT, _MODEL_AXIS, _MESH = prev


def make_mesh(shape: Sequence[int], names: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` with dimension ``names`` over the ranks
    of the default process group in order (rank ``r`` at row-major position
    ``r``), for the launcher to declare with ``data_axes``. The group must
    be initialized with exactly ``prod(shape)`` ranks. The mesh is on
    "cuda" under NCCL, else on "cpu"."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if len(shape) != len(names):
        raise ValueError(f"mesh shape {tuple(shape)} and names "
                         f"{tuple(names)} differ in length")
    n = 1
    for s in shape:
        n *= int(s)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n:
        raise ValueError(f"a {tuple(shape)} mesh needs a process group of "
                         f"{n} ranks (have {world})")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def data_shard_count() -> int:
    """Number of data-parallel shards (1 outside a launcher context)."""
    return _DATA_COUNT if _DATA_AXES else 1


def axis_group(name: str):
    """The process group of the declared mesh's dimension ``name``. Raises
    ``ValueError`` when no declared mesh has that dimension, as the
    reference's collectives do for an axis name that nothing binds."""
    names = getattr(_MESH, "mesh_dim_names", None) or ()
    if name not in names:
        raise ValueError(f"unbound axis name: {name!r} (declared mesh "
                         f"dimensions: {tuple(names)})")
    return _MESH.get_group(name)


def _axis(name):
    if name == "data":
        return _DATA_AXES if len(_DATA_AXES) > 1 else _DATA_AXES[0]
    if name == "model":
        return _MODEL_AXIS
    if name == "all":                      # every axis (long-context seq dim)
        axes = tuple(_DATA_AXES)
        if _MODEL_AXIS and _MODEL_AXIS not in axes:
            axes = axes + (_MODEL_AXIS,)
        return axes
    return None


def _redistribute(x, spec):
    """A DTensor moved to the placements that ``spec`` (one mesh axis name,
    a tuple of names, or None per tensor dim) asks of its mesh."""
    from torch.distributed.tensor import Replicate, Shard
    names = x.device_mesh.mesh_dim_names or ()
    placements = []
    for name in names:
        dims = [i for i, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        placements.append(Shard(dims[0]) if dims else Replicate())
    return x.redistribute(x.device_mesh, placements)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """Pin dim 0 of an activation to the data axes (rest unconstrained)."""
    if _DATA_AXES is None or x.ndim < 1 or not _is_dtensor(x):
        return x
    return _redistribute(x, (_axis("data"),) + (None,) * (x.ndim - 1))


def placed(x) -> bool:
    """Whether ``constrain`` acts on ``x``: a DTensor under ``data_axes``."""
    return _DATA_AXES is not None and _is_dtensor(x)


def constrain(x: torch.Tensor, dims: Sequence[Optional[str]]) -> torch.Tensor:
    """Pin arbitrary dims: dims entries are "data" | "model" | None."""
    if not placed(x):
        return x
    return _redistribute(x, tuple(_axis(d) for d in dims))
