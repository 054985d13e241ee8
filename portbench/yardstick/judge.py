"""The comparison that decides ``correct``, and the percentile of a tail.

Every answer the benchmark checks is exact (a count or a sum), so the one
number compared counts answers and its limit is 0: ``wrong``, the answers
checked that differ from the plain reference's or never came (a request
submitted in the window with no answer). A run that checked no answer at
all is not correct either.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

__all__ = ["LIMITS", "compare", "is_correct", "check_lines", "percentile"]

LIMITS = {"wrong": 0}


def compare(got: Dict[int, object], want: Dict[int, object]) -> dict:
    """``got``: answers that came, by request; ``want``: the reference's
    answers of the requests checked. -> ``wrong`` with ``checked`` and
    ``never_came`` (the part of ``wrong`` that never came) beside it."""
    never = sum(1 for rid in want if rid not in got)
    differ = sum(1 for rid, w in want.items()
                 if rid in got and got[rid] != w)
    return {"wrong": never + differ, "never_came": never,
            "checked": len(want)}


def is_correct(numbers: dict) -> bool:
    return numbers["checked"] > 0 and all(
        numbers[k] <= lim for k, lim in LIMITS.items())


def check_lines(numbers: dict) -> List[str]:
    """One line a number compared: its name, its reading, its limit."""
    return [f"check {k} {numbers[k]} limit {lim} (of {numbers['checked']} "
            f"answers checked, {numbers['never_came']} never came)"
            for k, lim in LIMITS.items()]


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile of the raw values (exact: no
    histogram in between)."""
    if not len(values):
        raise ValueError("no values")
    v = np.sort(np.asarray(values, np.float64))
    return float(v[max(0, math.ceil(q / 100.0 * v.size) - 1)])
