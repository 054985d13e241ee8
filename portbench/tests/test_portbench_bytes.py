"""Roaring's byte accounting against hand-worked containers, and the
device-trace reduction against hand-worked intervals."""

import numpy as np
import pytest

from portbench.yardstick import roaring_bytes as rb
from portbench.yardstick import trace


@pytest.mark.parametrize("ids, want", [
    ([], 0),
    ([7], 2 * 1),                                   # one array value
    ([1, 5, 9, 400], 2 * 4),                        # array
    (list(range(0, 8192, 2)), 2 * 4096),            # 4,096 values: array
    (list(range(0, 8194, 2)), 8192),                # 4,097: bitmap
    (list(range(0, 60000, 3)), 8192),               # 20,000 values: bitmap
    (list(range(100, 20100)), 4),                   # one run
    (list(range(0, 10)) + list(range(20, 30)), 8),  # two runs beat 40 bytes
    (list(range(65530, 65542)), 4 + 4),             # a run split by chunks
    ([3, 65536 + 3, 2 * 65536 + 3], 3 * 2),         # three chunks
])
def test_mask_bytes_hand_worked(ids, want):
    mask = np.zeros(3 * 65536 + 17, bool)
    mask[np.array(ids, np.int64)] = True
    assert rb.mask_bytes(mask) == want


def brute_bytes(mask):
    """Roaring bytes chunk by chunk, runs counted one row at a time."""
    total = 0
    for lo in range(0, mask.size, 1 << 16):
        rows = np.flatnonzero(mask[lo:lo + (1 << 16)]).tolist()
        if not rows:
            continue
        runs = 1 + sum(1 for a, b in zip(rows, rows[1:]) if b != a + 1)
        plain = 2 * len(rows) if len(rows) <= 4096 else 8192
        total += min(plain, 4 * runs)
    return total


def test_mask_bytes_match_brute_force_on_random_rows():
    rng = np.random.default_rng(3)
    for density in (0.001, 0.05, 0.5, 0.97):
        mask = rng.random(400_000) < density
        mask[70_000:140_000] = True                  # a long run
        assert rb.mask_bytes(mask) == brute_bytes(mask)


def test_container_bytes_boundary():
    assert rb.container_bytes(4096, 4096).item() == 8192
    assert rb.container_bytes(4097, 4097).item() == 8192
    assert rb.container_bytes(4097, 1).item() == 4
    assert rb.container_bytes(0, 0).item() == 0


def test_merge_and_gap_attribution():
    assert trace.merge([(5, 7), (0, 2), (1, 3), (6, 9)]) == [[0, 3], [5, 9]]
    gaps = [(0, 10), (20, 30)]
    spans = [(2, 4, "step"), (8, 22, "poll"), (25, 26, "step")]
    got = trace.attribute_gaps(gaps, spans)
    assert got == {"step": 3, "poll": 4, "(client)": 13}
