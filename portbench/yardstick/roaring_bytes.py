"""Bytes of a set of rows at Roaring's own sizes (Chambi et al., 2014).

Row ids split into chunks of 2^16 by their high 16 bits; a chunk's
container takes 2 bytes a value as an array (up to 4,096 values), else
8 KiB as a bitmap, or 4 bytes a run when that is smaller. These sizes are
counted from the ids themselves, not from how the program stores them, so
they read the same whatever implements the index.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ARRAY_MAX", "BITMAP_BYTES", "container_bytes", "mask_bytes"]

ARRAY_MAX = 4096
BITMAP_BYTES = 8192


def container_bytes(card, nruns):
    """Bytes of containers of ``card`` values in ``nruns`` runs (arrays of
    equal shape, or scalars); 0 for an empty container."""
    card = np.asarray(card, np.int64)
    nruns = np.asarray(nruns, np.int64)
    plain = np.where(card <= ARRAY_MAX, 2 * card, BITMAP_BYTES)
    return np.where(card == 0, 0, np.minimum(plain, 4 * nruns))


def mask_bytes(mask: np.ndarray) -> int:
    """Roaring bytes of ``{i : mask[i]}`` for a boolean row mask, without
    listing the rows."""
    mask = np.asarray(mask, bool)
    if mask.size == 0:
        return 0
    starts = mask.copy()                      # each row that begins a run
    starts[1:] &= ~mask[:-1]
    bounds = np.arange(0, mask.size, 1 << 16)
    starts[bounds] = mask[bounds]
    card = np.add.reduceat(mask, bounds, dtype=np.int64)
    nruns = np.add.reduceat(starts, bounds, dtype=np.int64)
    return int(container_bytes(card, nruns).sum())
