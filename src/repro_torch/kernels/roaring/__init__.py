"""Hand-written CUDA kernels for Roaring containers, their plain-torch
versions, and the entry points that pick between them by device."""

from .ops import fused_tree, intersect_dispatch, intersect_dispatch_stacked

__all__ = ["intersect_dispatch", "intersect_dispatch_stacked", "fused_tree"]
