"""Sharding rules: parameter-path patterns -> logical dims -> placements.

Strategy (single pod, mesh ("data", "model")):
  * tensor parallelism on "model": heads / mlp / experts / vocab;
  * FSDP (ZeRO-3) on "data": the remaining large dimension of each matrix;
  * activations: batch on "data", heads on "model", long-context KV sharded
    on sequence over "data".

Multi-pod mesh ("pod", "data", "model"): parameters are replicated across
pods (pure DP); the batch is additionally split over "pod". Gradient sync on
the pod axis is where Roaring gradient compression plugs in (grad_comp).

The rules are the reference's, and *logical*: ``spec_for_path`` matches
parameter tree paths and returns one mesh dimension name (or None) per
tensor dim, as a plain tuple (the reference's ``PartitionSpec`` as a
tuple). ``placements`` turns such a spec into DTensor placements on a
``torch.distributed.device_mesh.DeviceMesh`` (``Shard(d)`` on the mesh
dimension a tensor dim names, ``Replicate()`` on the others).

A mesh here is a ``DeviceMesh`` with named dimensions; the rules read only
its dimension sizes, so they also take a mapping of dimension name to size.
"""

from __future__ import annotations

import re
from typing import Mapping

from repro_torch import _tree

# (regex on 'path', rank) -> logical dims; first match wins.
# paths look like: blocks/0/attn/wq, embed/table, blocks/2/moe/wi ...
_RULES: list[tuple[str, tuple]] = [
    # embeddings: vocab on model (vocab-parallel logits); the embed dim
    # stays unsharded (sharding it on "data" would turn every logits product
    # into a [B, S, V / n] all-reduce over the data axis)
    (r"embed/table$", ("model", None)),
    (r"unembed/table$", ("model", None)),
    # attention projections (leading layer-stack dim handled generically)
    (r"attn/wq$", ("data", "model", None)),
    (r"attn/wk$", ("data", "model", None)),
    (r"attn/wv$", ("data", "model", None)),
    (r"attn/wo$", ("model", None, "data")),
    (r"xattn/w[qkv]$", ("data", "model", None)),
    (r"xattn/wo$", ("model", None, "data")),
    # dense MLP
    (r"mlp/w[ig]$", ("data", "model")),
    (r"mlp/wo$", ("model", "data")),
    # MoE: expert parallelism on "model", FSDP inside each expert on "data"
    (r"moe/router$", (None, "model")),
    (r"moe/w[ig]$", ("model", "data", None)),
    (r"moe/wo$", ("model", "data", None)),
    # mamba
    (r"mamba/in_proj$", ("data", "model")),
    (r"mamba/out_proj$", ("model", "data")),
    (r"mamba/x_proj$", ("model", None)),
    (r"mamba/conv_w$", (None, "model")),
    # rwkv time/channel mix
    (r"tm/w[rkvg]$", ("data", "model")),
    (r"tm/wo$", ("model", "data")),
    (r"tm/w_decay$", ("data", "model")),
    (r"tm/cwi$", ("data", "model")),
    (r"tm/cwo$", ("model", "data")),
]

# optimizer-state suffixes: same layout as the parameter (m, v), row/col
# factored stats (vr drops the last dim, vc the second-to-last), or flat
# quantized blocks (replicated: they are 1-D reshapes).
_OPT_SUFFIXES = {"m": "same", "v": "same", "vr": "drop_last",
                 "vc": "drop_second_last", "mq": "flat", "vq": "flat",
                 "ms": "flat", "vs": "flat"}


def mesh_sizes(mesh) -> dict:
    """``{dimension name: size}`` of a named ``DeviceMesh`` (or of a
    mapping, returned as a dict)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh's dimensions have no names")
    return dict(zip(names, mesh.shape))


def _path_str(path) -> str:
    if isinstance(path, str):
        return path
    return "/".join(str(p) for p in path)


def spec_for_path(path, leaf, mesh) -> tuple:
    """Logical dims for one parameter (or optimizer-state) leaf: a tuple
    with one mesh dimension name or None per leading tensor dim, trailing
    Nones dropped (``()`` replicates).

    ``path`` is a ``/``-joined string or a tuple of keys and positions
    (``_tree.leaves_with_paths``). Layer-stack leading dims pass through
    unsharded; small vectors replicate. Optimizer states inherit the
    parameter's spec through their path prefix.
    """
    s = _path_str(path)
    parts = s.split("/")
    mode = "same"
    if parts and parts[-1] in _OPT_SUFFIXES:
        mode = _OPT_SUFFIXES[parts[-1]]
        s = "/".join(parts[:-1])
        if mode == "flat":
            return ()
    ndim = leaf.ndim
    for pat, dims in _RULES:
        if re.search(pat, s):
            dims = tuple(dims)
            if mode == "drop_last":
                dims = dims[:-1]
            elif mode == "drop_second_last":
                dims = dims[:-2] + dims[-1:] if len(dims) >= 2 else dims
            extra = ndim - len(dims)          # leading stack dims
            if extra < 0:
                dims = dims[-ndim:] if ndim > 0 else ()
                extra = 0
            spec = (None,) * extra + tuple(dims)
            return _prune(spec, leaf, mesh_sizes(mesh))
    return ()                                  # replicate (norms, biases, ...)


def _prune(spec, leaf, sizes: dict) -> tuple:
    """Drop axis assignments that don't divide the dimension size."""
    shape = leaf.shape
    out = []
    for i, ax in enumerate(spec):
        if ax is None or ax not in sizes:
            out.append(None)
        elif shape[i] % sizes[ax] == 0 and shape[i] >= sizes[ax]:
            out.append(ax)
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements on ``mesh`` for a logical spec: ``Shard(d)`` on
    each mesh dimension that tensor dim ``d`` names (alone or in a tuple of
    names), ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _leaf_specs(params, mesh, mode: str) -> list:
    if mode not in ("auto", "replicate"):
        raise ValueError(f"mode must be 'auto' or 'replicate' (got {mode!r})")
    return [() if mode == "replicate" else spec_for_path(path, leaf, mesh)
            for path, leaf in _tree.leaves_with_paths(params)]


def params_specs(params, mesh, mode: str = "auto"):
    """A tree shaped like ``params`` whose leaves are logical specs: the
    reference's ``params_shardings``, each ``NamedSharding``'s spec as a
    tuple (read them in ``params``' order with ``_tree.leaf_nodes``).
    mode="auto": the FSDP + TP rules above. mode="replicate": pure data
    parallelism, every leaf replicated (``()``), for models whose matrices
    are too small to pay for model-axis collectives."""
    return _tree.unflatten(params, _leaf_specs(params, mesh, mode))


def params_shardings(params, mesh, mode: str = "auto"):
    """A tree shaped like ``params`` whose leaves are the placement tuples
    of ``params_specs`` on the ``DeviceMesh`` ``mesh``."""
    return _tree.unflatten(params, [placements(spec, mesh) for spec in
                                    _leaf_specs(params, mesh, mode)])


def batch_spec(mesh, mode: str = "auto") -> tuple:
    """Token batches: batch dim over every data-parallel axis present; in
    "replicate" (pure data parallel) mode the model axis carries batch
    too."""
    sizes = mesh_sizes(mesh)
    names = ("pod", "data", "model") if mode == "replicate" else ("pod",
                                                                  "data")
    axes = [a for a in names if a in sizes]
    return (tuple(axes) if len(axes) > 1 else axes[0],) if axes else ()


def seq_sharded_cache_spec(mesh) -> tuple:
    """Long-context KV caches: [B, S, KVH, hd] with sequence over 'data'
    (sequence parallelism) and heads over 'model'."""
    return (None, "data", "model", None)


def kv_cache_spec(mesh) -> tuple:
    """Standard decode caches: batch over data axes, heads over model."""
    sizes = mesh_sizes(mesh)
    axes = [a for a in ("pod", "data") if a in sizes]
    b = tuple(axes) if len(axes) > 1 else (axes[0] if axes else None)
    return (b, None, "model", None)


def activation_spec(mesh) -> tuple:
    return batch_spec(mesh)


# ---------------------------------------------------------------------------
# posting stacks (repro_torch.search): term axis over the data mesh axis
# ---------------------------------------------------------------------------

def posting_spec(mesh, axis: str = "data") -> tuple:
    """Logical dims of a stacked posting slab ``[n_terms, C, ...]``: the
    *term* axis shards over ``mesh[axis]`` (each rank owns a contiguous
    slice of the vocabulary); container rows and payloads stay whole so
    every per-term gather is rank-local."""
    return (axis if axis in mesh_sizes(mesh) else None,)


def shard_postings(stack, mesh, axis: str = "data"):
    """A stacked ``RoaringSlab`` whose leaves are DTensors on ``mesh`` with
    the leading term axis placed per ``posting_spec``. Every rank holds the
    whole stack and keeps its own contiguous block of rows, so nothing
    crosses ranks. The term count must divide the mesh axis size —
    ``search.PostingIndex.shard`` pads the stack with empty rows to
    guarantee that."""
    from torch.distributed.tensor import DTensor
    from repro_torch.roaring.slab import RoaringSlab

    pl = placements(posting_spec(mesh, axis), mesh)
    n = stack.n_slabs
    if axis in mesh_sizes(mesh):
        size, rank = mesh_sizes(mesh)[axis], mesh.get_local_rank(axis)
        if n % size:
            raise ValueError(f"{n} stack rows do not divide over {size} "
                             f"ranks of {axis!r}")
        lo, hi = rank * (n // size), (rank + 1) * (n // size)
    else:
        lo, hi = 0, n

    def place(x):
        local = x[lo:hi] if hi - lo == n else x[lo:hi].clone()
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=x.shape, stride=x.stride())

    return RoaringSlab(keys=place(stack.keys), kinds=place(stack.kinds),
                       cards=place(stack.cards), nruns=place(stack.nruns),
                       payload=place(stack.payload), C=stack.C)
