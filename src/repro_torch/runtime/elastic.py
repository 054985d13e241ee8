"""Elastic scaling: rebuild the mesh from surviving ranks and re-shard.

On a real fleet, losing a pod (or scaling one in) changes the set of ranks;
the recovery path is: (1) rebuild a ``DeviceMesh`` over the surviving ranks
with the same logical dimension names, (2) re-apply the sharding rules
(they are logical, so they re-resolve against the new mesh shape —
``_prune`` drops axes that no longer divide), (3) distribute the restored
checkpoint onto the new placements. The data-parallel batch follows the
new "data" dimension's size; the data pipeline's shard count is updated
accordingly.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.distributed.sharding import params_shardings


def elastic_remesh(axis_names: Sequence[str],
                   ranks: Optional[Sequence[int]] = None,
                   model_parallel: int = 1):
    """Build the largest ``DeviceMesh`` with the given dimension names over
    ``ranks`` (default: every rank of the default process group).

    Keeps the model dimension fixed (the parameter layout must still fit)
    and absorbs rank loss on the data dimension — the standard elastic-DP
    policy: shape ``(data, model_parallel)`` for two names, ``(1, data,
    model_parallel)`` for three. Every rank of the group calls it.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    n = len(ranks)
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"{n} ranks do not divide into model_parallel "
                         f"{model_parallel}")
    data = n // model_parallel
    if len(axis_names) == 2:
        shape = (data, model_parallel)
    elif len(axis_names) == 3:
        shape = (1, data, model_parallel)
    else:
        raise ValueError(axis_names)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = torch.tensor(ranks[: int(np.prod(shape))]).reshape(shape)
    return DeviceMesh(device_type, mesh, mesh_dim_names=tuple(axis_names))


def reshard_tree(tree, mesh):
    """Re-apply the logical sharding rules against a (possibly new) mesh:
    every leaf becomes a DTensor distributed from rank 0's copy onto its
    ``params_shardings`` placements."""
    from torch.distributed.tensor import distribute_tensor

    def put(node, pl):
        if isinstance(node, dict):
            return {k: put(node[k], pl[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(put(v, p) for v, p in zip(node, pl))
        return distribute_tensor(node, mesh, pl)

    return put(tree, params_shardings(tree, mesh))
