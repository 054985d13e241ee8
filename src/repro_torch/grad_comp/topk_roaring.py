"""Roaring top-k gradient compression for cross-pod data parallelism.

Top-k magnitude sparsification turns a gradient leaf into (indices, values).
The index set is exactly the paper's workload: sorted 32-bit integers, often
clustered (attention sinks, hot embedding rows) — so it is encoded as a
``RoaringSlab``: chunked by high-16 bits, array containers for scattered
coordinates, bitmap containers for dense hot regions, per-chunk cardinality
counters for exact sizing without decompression.

Cross-pod sync all-gathers the compressed (slab, values) payloads over the
process group of the "pod" mesh dimension and merges them as a scatter-add
of each pod's sparse contribution (values must sum, not OR), in rank order.

The selection follows ``jax.lax.top_k``'s order: among equal magnitudes the
lower index is kept. ``torch.topk`` promises no order among ties, so it
gives only the k-th magnitude ``t``; every index with ``|g| > t`` is kept
and the rest filled from the lowest indices with ``|g| == t``. The slabs,
values and means are the reference's, byte for byte.

Support overlaps run through the kind-dispatch kernels: ``leaf_overlap`` /
``leaf_jaccard`` through ``intersect_dispatch``, ``leaf_overlap_many``
through one ``stacked_card_kernel`` launch.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.core import torch_roaring as tr
from repro_torch.roaring.slab import RoaringSlab, stack

# elements scanned at a time for the lowest tied indices (bounds the
# scan's index buffer where a leaf holds many equal magnitudes, e.g. zeros)
_TIE_CHUNK = 1 << 24


class CompressedLeaf(NamedTuple):
    """Compressed gradient leaf: the index set as a ``RoaringSlab`` plus
    the f32 values in ascending index order."""

    slab: RoaringSlab       # index set (keys/kinds/cards/nruns/payload)
    values: torch.Tensor    # f32[k]


def _capacity_for(n: int, k: int) -> int:
    """Static container capacity: every 2^16-chunk the indices could touch."""
    return max(1, min((n + tr.CHUNK_SIZE - 1) // tr.CHUNK_SIZE, 2 * k))


def _topk_indices(mag: torch.Tensor, k: int) -> torch.Tensor:
    """Ascending i64 indices of the ``k`` largest entries of the 1-D
    ``mag``, ties going to the lower index (``jax.lax.top_k``'s set)."""
    n = mag.numel()
    if k >= n:
        return torch.arange(n, device=mag.device)
    if k <= 0:
        return torch.zeros((0,), dtype=torch.int64, device=mag.device)
    t = torch.topk(mag, k, sorted=False).values.min()
    parts = [torch.nonzero(mag > t).flatten()]
    need = k - parts[0].numel()
    for lo in range(0, n, _TIE_CHUNK):
        if need == 0:
            break
        hit = torch.nonzero(mag[lo:lo + _TIE_CHUNK] == t).flatten()[:need]
        parts.append(hit + lo)
        need -= hit.numel()
    return torch.sort(torch.cat(parts)).values


def compress_leaf(g: torch.Tensor, k: int) -> CompressedLeaf:
    """Top-k by |g|; indices Roaring-encoded, values packed in index order."""
    flat = g.detach().to(torch.float32).reshape(-1)
    n = flat.numel()
    k = min(k, n)
    idx = _topk_indices(flat.abs(), k)
    slab = RoaringSlab.from_indices(
        idx, torch.ones((k,), dtype=torch.bool, device=flat.device),
        _capacity_for(n, k))
    return CompressedLeaf(slab, flat[idx])


def _scatter_add(acc: torch.Tensor, c: CompressedLeaf) -> None:
    """``acc[i] += v`` for every (index, value) of ``c``; ``acc`` has one
    drop slot past the leaf's ``n`` elements for padded indices."""
    idx, valid = c.slab.to_indices(c.values.shape[0])
    n = acc.numel() - 1
    acc.index_add_(0, torch.where(valid, idx, n),
                   c.values * valid.to(torch.float32))


def decompress_leaf(c: CompressedLeaf, shape, dtype) -> torch.Tensor:
    """Scatter values back to a dense leaf."""
    n = int(np.prod(shape))
    out = torch.zeros((n + 1,), dtype=torch.float32, device=c.values.device)
    _scatter_add(out, c)
    return out[:n].reshape(shape).to(dtype)


def _k_for(n: int, ratio: float, min_k: int) -> int:
    return max(min_k, int(math.ceil(n * ratio)))


def compress_tree(grads, ratio: float = 0.01, min_k: int = 64):
    """Compress every leaf to ceil(ratio * n) entries (at least ``min_k``)."""
    return _tree.tree_map(
        lambda g: compress_leaf(g, _k_for(g.numel(), ratio, min_k)), grads)


def decompress_tree(compressed, like):
    """Dense leaves shaped and typed like ``like``'s from a tree of
    ``CompressedLeaf`` (as ``compress_tree`` returns it)."""
    leaves = _tree.leaves(like)
    comp = _compressed_leaves(compressed)
    if len(comp) != len(leaves):
        raise ValueError("trees differ in their number of leaves")
    return _tree.unflatten(like, [decompress_leaf(c, p.shape, p.dtype)
                                  for c, p in zip(comp, leaves)])


def _compressed_leaves(tree) -> list:
    """The ``CompressedLeaf`` leaves of ``tree`` in the reference's order
    (a ``CompressedLeaf`` is a tuple, so ``_tree.leaves`` would open it)."""
    if isinstance(tree, CompressedLeaf):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _compressed_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _compressed_leaves(v)]
    raise TypeError(f"not a CompressedLeaf: {type(tree).__name__}")


def leaf_overlap(c1: CompressedLeaf, c2: CompressedLeaf) -> torch.Tensor:
    """|idx(c1) ∩ idx(c2)| via the cardinality-only dispatch path (the
    top-k support stability between steps), nothing decompressed."""
    return c1.slab.and_card(c2.slab)


def leaf_jaccard(c1: CompressedLeaf, c2: CompressedLeaf) -> torch.Tensor:
    """Jaccard similarity of two compressed index sets."""
    return c1.slab.jaccard(c2.slab)


def leaf_overlap_many(c: CompressedLeaf, others) -> torch.Tensor:
    """i32[N] of |idx(c) ∩ idx(o_i)| over many compressed leaves at once:
    one stacked dispatch launch through the query engine, nothing
    decompressed. The stack's capacity is the exact merged live-key count
    across the others' slabs."""
    from repro_torch import index
    if not others:
        return torch.zeros((0,), dtype=torch.int32, device=c.values.device)
    slabs = [o.slab for o in others]
    live = torch.unique(torch.cat([s.keys for s in slabs]))
    cap = max(1, int((live != tr.KEY_SENTINEL).sum()))
    return index.batched_and_card(stack(slabs, capacity=cap), c.slab)


def leaf_topk_overlap(c: CompressedLeaf, others, k: int):
    """Top-k of ``leaf_overlap_many`` — (scores i32[k], indices i32[k]),
    the higher score first and, among equal scores, the lower index: which
    history steps' supports this leaf's top-k overlaps most."""
    scores = leaf_overlap_many(c, others)
    order = torch.sort(scores, descending=True, stable=True)
    return order.values[:k], order.indices[:k].to(torch.int32)


def compression_ratio(c: CompressedLeaf, n: int) -> float:
    """Exact Roaring-encoded bits vs dense f32 gradient bits.

    From the per-container cardinality counters (paper S2): array
    containers cost 16 bits/index, bitmap containers 2^16 bits flat, plus a
    32-bit header per container; values add 32 bits each.
    """
    card = c.slab.cards.cpu().numpy()
    kind = c.slab.kinds.cpu().numpy()
    bits = 32 * int((kind != 0).sum())
    bits += int((16 * card[kind == 1]).sum())
    bits += int((kind == 2).sum()) * (1 << 16)
    bits += 32 * int(c.values.shape[0])
    return bits / (32.0 * n)


def _all_gather_leaf(c: CompressedLeaf, group, n_pods: int) -> list:
    """Every rank's ``CompressedLeaf`` in rank order. The u16 payload moves
    as bytes and the rest as i32 / f32: NCCL and gloo carry no int16."""
    s = c.slab
    sent = [s.keys, s.kinds, s.cards, s.nruns,
            s.payload.view(torch.uint8), c.values]
    got = []
    for x in sent:
        parts = [torch.empty_like(x) for _ in range(n_pods)]
        torch.distributed.all_gather(parts, x.contiguous(), group=group)
        got.append(parts)
    return [CompressedLeaf(RoaringSlab(
        keys=got[0][r], kinds=got[1][r], cards=got[2][r], nruns=got[3][r],
        payload=got[4][r].view(torch.int16), C=s.C), got[5][r])
        for r in range(n_pods)]


def compressed_crosspod_mean(grads, *, axis_name: str, ratio: float = 0.01,
                             min_k: int = 64):
    """The Roaring top-k stand-in for a mean all-reduce over the pod axis.

    ``axis_name`` names a dimension of the mesh declared by
    ``distributed.context.data_axes``; with none it raises, as the
    reference's unbound axis name does. For each leaf in turn: compress
    locally, all-gather the fixed-shape compressed leaves in that
    dimension's process group, scatter-add every rank's part in rank order
    into an f32 accumulator, divide by the group size and cast back. Each
    leaf's mean is written into the leaf itself, so no second copy of the
    gradients is held; returns ``grads``. Error feedback is left to the
    caller.
    """
    import torch.distributed as dist
    from repro_torch.distributed import context

    group = context.axis_group(axis_name)
    n_pods = dist.get_world_size(group)
    for g in _tree.leaves(grads):
        n = g.numel()
        parts = _all_gather_leaf(compress_leaf(g, _k_for(n, ratio, min_k)),
                                 group, n_pods)
        acc = torch.zeros((n + 1,), dtype=torch.float32, device=g.device)
        for c in parts:
            _scatter_add(acc, c)
        del parts
        g.copy_((acc[:n] / n_pods).reshape(g.shape))
        del acc
    return grads
