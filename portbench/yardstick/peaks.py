"""Published peaks of the cards the benchmark runs on.

NVIDIA H100 SXM data sheet, at the full 700 W power limit: a card set
lower runs slower under load, so every reading is kept beside the card's
name and power limit.
"""

from __future__ import annotations

__all__ = ["PEAKS", "peak"]

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def peak(kind: str, what: str) -> float:
    """One published peak of the card named ``kind``; KeyError when the
    table does not know the card, so no reading is made against a guess."""
    return PEAKS[kind][what]
