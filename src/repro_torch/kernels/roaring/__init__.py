"""Hand-written CUDA kernels for Roaring containers, their plain-torch
versions, and the entry points that pick between them by device."""

from .ops import (array_intersect, container_op, fused_tree,
                  intersect_dispatch, intersect_dispatch_stacked)

__all__ = ["container_op", "array_intersect", "intersect_dispatch",
           "intersect_dispatch_stacked", "fused_tree"]
