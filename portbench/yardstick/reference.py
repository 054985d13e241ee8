"""The plain reference: the same questions answered by NumPy alone.

It works from the benchmark's own inputs (the SSB rows that ``gen`` made)
and takes nothing that the program made. It imports NumPy and nothing
else: not JAX, not ``repro``, not ``repro_torch``. ``ssb_mask`` /
``ssb_answer``: SSB's row filter over LINEORDER, the row count and
``sum(col * weight)`` (SSB Q1's revenue).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["ssb_mask", "ssb_answer", "cond_values"]


def cond_values(cond) -> tuple:
    """``("eq", col, v)`` / ``("range", col, lo, hi)`` -> (col, lo, hi),
    closed bounds, ``None`` open."""
    if cond[0] == "eq":
        return cond[1], cond[2], cond[2]
    if cond[0] == "range":
        return cond[1], cond[2], cond[3]
    raise ValueError(f"not a condition: {cond!r}")


def ssb_mask(records: Dict[str, np.ndarray], conds) -> np.ndarray:
    """Rows meeting every condition (a conjunction)."""
    out = None
    for cond in conds:
        col, lo, hi = cond_values(cond)
        v = records[col]
        m = np.ones(v.shape, bool)
        if lo is not None:
            m &= v >= lo
        if hi is not None:
            m &= v <= hi
        out = m if out is None else out & m
    if out is None:
        raise ValueError("a query needs at least one condition")
    return out


def ssb_answer(records: Dict[str, np.ndarray], conds, *, sum_col=None,
               weight_col=None) -> int:
    """The row count (no ``sum_col``), ``sum(sum_col)``, or
    ``sum(sum_col * weight_col)`` over the filtered rows, exact in int64."""
    m = ssb_mask(records, conds)
    if sum_col is None:
        return int(np.count_nonzero(m))
    x = records[sum_col][m].astype(np.int64)
    if weight_col is not None:
        x = x * records[weight_col][m].astype(np.int64)
    return int(x.sum(dtype=np.int64))
