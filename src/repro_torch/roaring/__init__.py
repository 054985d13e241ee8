"""``repro_torch.roaring`` — the slab object and the portable codec."""

from repro_torch.roaring.format import (DecodeLimits, RoaringFormatError,
                                        RoaringFormatSpec)
from repro_torch.roaring.slab import RoaringSlab

__all__ = ["RoaringSlab", "RoaringFormatSpec", "RoaringFormatError",
           "DecodeLimits"]
