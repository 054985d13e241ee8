"""Production meshes, as ``torch.distributed`` device meshes.

Single pod: 256 ranks as ("data", "model") = (16, 16).
Multi-pod:  512 ranks as ("pod", "data", "model") = (2, 16, 16); the pod
dimension carries pure data parallelism (per-pod parameter replicas, the
gradient mean over pods, optionally Roaring-compressed by
``grad_comp``).

Functions, not module constants: importing this module touches no device
and no process group. Every rank of the default process group calls them;
the group must hold exactly as many ranks as the mesh
(``distributed.context.make_mesh``).
"""

from __future__ import annotations

from repro_torch.distributed import context


def production_mesh_sizes(*, multi_pod: bool = False) -> dict:
    """``{dimension name: size}`` of a production mesh, in mesh order (what
    ``launch.specs.build_cell`` and the dry run read; no process group)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_production_mesh(*, multi_pod: bool = False):
    sizes = production_mesh_sizes(multi_pod=multi_pod)
    return context.make_mesh(tuple(sizes.values()), tuple(sizes))


def make_test_mesh(data: int = 2, model: int = 2):
    """A small ("data", "model") mesh for tests (``data * model`` ranks)."""
    return context.make_mesh((data, model), ("data", "model"))
