"""Nested dicts / lists of tensors, flattened in the reference's order.

The reference's parameter and train-state pytrees are dicts and lists; JAX
flattens a dict by its sorted keys and a list in order. These helpers do
the same for the port's nested dicts of tensors, so a leaf's index means
the same leaf in both packages (the checkpoint layout relies on it).
"""

from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in the reference's flattening order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def leaves_with_paths(tree: Any, prefix: tuple = ()) -> List[tuple]:
    """``(path, leaf)`` pairs in ``leaves`` order; a path is the tuple of
    dict keys and list positions from the root (the reference's key path:
    ``("blocks", 0, "attn", "wq")`` reads ``blocks/0/attn/wq``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves_with_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaves_with_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def leaf_nodes(like: Any, tree: Any) -> List[Any]:
    """The nodes of ``tree`` at the positions of ``like``'s leaves, in
    ``leaves`` order: for a tree shaped like ``like`` whose leaves are
    trees themselves (an optimizer's per-parameter state)."""
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in leaf_nodes(like[k],
                                                            tree[k])]
    if isinstance(like, (list, tuple)):
        return [x for a, b in zip(like, tree, strict=True)
                for x in leaf_nodes(a, b)]
    return [tree]


def unflatten(like: Any, flat: List[Any]) -> Any:
    """A tree shaped like ``like`` whose leaves are ``flat``, in order."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over corresponding leaves of ``tree`` and ``rest``."""
    cols = [leaves(t) for t in (tree, *rest)]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])


def describe(tree: Any) -> str:
    """The structure of ``tree`` as text (dict keys, list lengths, ``*``
    for a leaf), for a checkpoint's manifest."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(describe(v) for v in tree) + "]"
    return "*"
