"""The store's predicate language — a tiny, closed AST over named columns
(the port's own copy of the reference package's pure-Python module).

This is the *logical* query surface of ``repro_torch.store``: ``eq`` /
``in_`` / ``range_`` atoms over columns combined with ``and_`` / ``or_`` /
``not_``. Predicates are plain frozen dataclasses with no knowledge of
bitmaps — the ``BitmapStore`` compiles them into ``repro_torch.index``
expression trees over its posting slabs (equality columns) and bit-sliced
slices (integer columns), so every query runs through the fused executor
and its degradation ladder.

Atoms are schema-checked at *compile* time (unknown column, ``range_`` over
a non-integer equality column, malformed bounds), not at construction —
the same predicate object can be compiled against any store whose schema
supports it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

__all__ = [
    "Pred", "Eq", "In", "Range", "AndP", "OrP", "NotP",
    "eq", "in_", "range_", "and_", "or_", "not_",
]

# column values a predicate may name: the store's equality columns hold
# python ints or strings (numpy scalars are normalized at build time)
Value = Union[int, str]


@dataclasses.dataclass(frozen=True)
class Pred:
    """Base class for store predicates (static structure)."""


@dataclasses.dataclass(frozen=True)
class Eq(Pred):
    """``column == value``."""

    col: str
    value: Value


@dataclasses.dataclass(frozen=True)
class In(Pred):
    """``column ∈ values`` (an OR of equalities; duplicates are harmless)."""

    col: str
    values: Tuple[Value, ...]


@dataclasses.dataclass(frozen=True)
class Range(Pred):
    """``lo <= column <= hi`` (closed bounds; ``None`` leaves a side open).

    On a bit-sliced integer column this compiles to the O'Neil/Quass
    slice-comparison tree; on an integer-valued equality column it compiles
    to an OR over the stored values inside the bounds.
    """

    col: str
    lo: Optional[int]
    hi: Optional[int]


@dataclasses.dataclass(frozen=True)
class AndP(Pred):
    """N-ary conjunction."""

    children: Tuple[Pred, ...]


@dataclasses.dataclass(frozen=True)
class OrP(Pred):
    """N-ary disjunction."""

    children: Tuple[Pred, ...]


@dataclasses.dataclass(frozen=True)
class NotP(Pred):
    """Complement over the store's full row universe."""

    child: Pred


def eq(col: str, value: Value) -> Eq:
    """``col == value`` atom."""
    return Eq(col, _norm_value(value))


def in_(col: str, values) -> In:
    """``col IN values`` atom (any iterable of values)."""
    return In(col, tuple(_norm_value(v) for v in values))


def range_(col: str, lo: Optional[int] = None,
           hi: Optional[int] = None) -> Range:
    """``lo <= col <= hi`` atom — closed bounds, ``None`` = unbounded.

    At least one bound is required (an all-open range is just the universe,
    which a query never needs to spell as a range).
    """
    if lo is None and hi is None:
        raise ValueError("range_ needs at least one bound")
    lo_i = None if lo is None else int(lo)
    hi_i = None if hi is None else int(hi)
    if lo_i is not None and hi_i is not None and lo_i > hi_i:
        raise ValueError(f"range_ bounds inverted: lo {lo_i} > hi {hi_i}")
    return Range(col, lo_i, hi_i)


def and_(*children: Pred) -> Pred:
    """N-ary AND (``and_(p)`` collapses to ``p``; >= 1 child required)."""
    if not children:
        raise ValueError("and_() needs at least one child predicate")
    _check_preds(children)
    return children[0] if len(children) == 1 else AndP(tuple(children))


def or_(*children: Pred) -> Pred:
    """N-ary OR (``or_(p)`` collapses to ``p``; >= 1 child required)."""
    if not children:
        raise ValueError("or_() needs at least one child predicate")
    _check_preds(children)
    return children[0] if len(children) == 1 else OrP(tuple(children))


def not_(child: Pred) -> NotP:
    """Complement over the store's row universe."""
    _check_preds((child,))
    return NotP(child)


def _check_preds(children) -> None:
    for c in children:
        if not isinstance(c, Pred):
            raise TypeError(f"not a store predicate: {c!r}")


def _norm_value(v) -> Value:
    """Normalize a column value to a plain python int or str (numpy scalars
    and bools fold to int) so predicate equality and JSON metadata agree."""
    if isinstance(v, str):
        return v
    if isinstance(v, (bool,)):
        return int(v)
    try:
        return int(v)            # numpy integer scalars land here
    except (TypeError, ValueError):
        raise TypeError(f"unsupported column value type: {type(v).__name__} "
                        f"({v!r}); store columns hold ints or strings")
