"""Host-side builders shared by the store and the search index.

``_posting`` canonicalizes sorted row ids into a best-of-three host bitmap;
``_stack_bitmaps`` places many host bitmaps into ONE stacked
``RoaringSlab`` aligned to the row universe's chunk keys, in one shot on the
host, then moves it to the device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core import py_roaring as pr
from repro_torch.core import torch_roaring as tr
from repro_torch.roaring.slab import RoaringSlab


def _posting(row_ids: np.ndarray) -> pr.RoaringBitmap:
    """Sorted row ids -> best-of-three canonical host bitmap (canonical
    kinds are what make stored bytes match the engine's query outputs)."""
    return pr.RoaringBitmap.from_sorted_unique(
        np.asarray(row_ids, np.int64)).run_optimize()


def _stack_bitmaps(bitmaps: Sequence[pr.RoaringBitmap], n_rows: int,
                   n_chunks: int, device) -> RoaringSlab:
    """Host bitmaps -> ONE stacked ``RoaringSlab`` aligned to the row
    universe's chunk keys (every posting is a subset of ``[0, n_rows)``, so
    the shared key row is ``arange(n_chunks)``)."""
    N = len(bitmaps)
    kinds = np.zeros((N, n_chunks), np.int32)
    cards = np.zeros((N, n_chunks), np.int32)
    nruns = np.zeros((N, n_chunks), np.int32)
    payload = np.zeros((N, n_chunks, tr.ROW_WORDS), np.uint16)
    for s, rb in enumerate(bitmaps):
        for k, c in zip(rb.keys, rb.containers):
            cards[s, k] = c.cardinality
            if isinstance(c, pr.RunContainer):
                kinds[s, k] = tr.KIND_RUN
                nruns[s, k] = c.n_runs
                row = payload[s, k]
                row[:] = 0xFFFF
                row[0:2 * c.n_runs:2] = c.starts.astype(np.uint16)
                row[1:2 * c.n_runs:2] = c.lengths.astype(np.uint16)
            elif isinstance(c, pr.BitmapContainer):
                kinds[s, k] = tr.KIND_BITMAP
                payload[s, k] = c.words.view(np.uint16)
            else:
                kinds[s, k] = tr.KIND_ARRAY
                row = payload[s, k]
                row[:] = 0xFFFF
                row[: c.arr.size] = c.arr
    if n_rows > 0:
        keys_row = np.arange(n_chunks, dtype=np.int32)
    else:
        keys_row = np.full((n_chunks,), tr.KEY_SENTINEL, np.int32)
    keys = np.broadcast_to(keys_row, (N, n_chunks))
    return RoaringSlab.from_numpy(keys, kinds, cards, nruns, payload,
                                  device=device)
