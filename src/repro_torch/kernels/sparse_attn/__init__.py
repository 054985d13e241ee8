"""Attention kernels over Roaring-derived block and page lists: the
hand-written block-sparse flash and paged-decode CUDA kernels, their plain
versions, and the entry points that pick between them by device."""

from .ops import paged_decode, sparse_attention

__all__ = ["paged_decode", "sparse_attention"]
