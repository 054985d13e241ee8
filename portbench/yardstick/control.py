"""Controls: the reference put in the program's place with one guarantee
of the configuration broken, which the comparison has to catch.

* Counts (``ssb-q1-count``): the configuration states exact answers. The
  next precision below its int64 counts, int32, holds every count under
  2^31 exactly and so cannot fail, so the count control breaks exactness
  instead, the way a planner's estimate does: each 2^16-row chunk's share
  of matching rows is worked out from its per-condition shares as if they
  were independent, and the count is the rounded sum over chunks. On the
  benchmark's data, whose columns are drawn independently, it lands close
  to the true count and rarely on it.
* Sums (``ssb-q1-revenue``): the configuration states int64 sums; the
  control accumulates ``sum(col * weight)`` in int32, wrapping as an int32
  accumulator on the card would.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from . import reference as ref

__all__ = ["CHUNK", "chunk_cards", "estimate_ssb_count", "int32_ssb_sum"]

CHUNK = 1 << 16


def chunk_cards(ids: np.ndarray, n_chunks: int) -> np.ndarray:
    """``int64[n_chunks]``: how many of the ``ids`` fall in each chunk."""
    return np.bincount(np.asarray(ids, np.int64) >> 16,
                       minlength=n_chunks)[:n_chunks]


def _chunk_sizes(n: int) -> np.ndarray:
    c = -(-n // CHUNK)
    sizes = np.full(c, CHUNK, np.float64)
    sizes[-1] = n - (c - 1) * CHUNK
    return sizes


def estimate_ssb_count(records: Dict[str, np.ndarray], conds) -> int:
    """An SSB conjunction's row count under independence, chunk by chunk."""
    n = len(next(iter(records.values())))
    sizes = _chunk_sizes(n)
    share = np.ones(sizes.size)
    for cond in conds:
        m = ref.ssb_mask(records, [cond])
        share *= chunk_cards(np.nonzero(m)[0], sizes.size) / sizes
    return int(np.rint((share * sizes).sum()))


def int32_ssb_sum(records: Dict[str, np.ndarray], conds, sum_col: str,
                  weight_col=None) -> int:
    """``sum(sum_col [* weight_col])`` over the filtered rows with an int32
    accumulator."""
    m = ref.ssb_mask(records, conds)
    x = records[sum_col][m].astype(np.int32)
    if weight_col is not None:
        x = x * records[weight_col][m].astype(np.int32)
    return int(x.sum(dtype=np.int32))
