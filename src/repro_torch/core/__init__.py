"""``repro_torch.core`` — the host oracle (``py_roaring``) and the torch
container slab (``torch_roaring``)."""

from .py_roaring import (ArrayContainer, BitmapContainer, RoaringBitmap,
                         RunContainer)

__all__ = ["RoaringBitmap", "ArrayContainer", "BitmapContainer",
           "RunContainer"]
