"""Attention kernels over Roaring-derived block and page lists: the
hand-written paged-decode CUDA kernel, its plain version, and the entry
point that picks between them by device. The block-sparse training kernel
comes with the training slice (ROADMAP queue 2)."""

from .ops import paged_decode

__all__ = ["paged_decode"]
