"""31-bit group-stream helpers shared by the WAH and Concise codecs.

Both formats segment the logical bit sequence into groups of w-1 = 31 bits.
A "group stream" is a dense uint32 array of group payloads (bit 31 unused).
"""

from __future__ import annotations

import numpy as np

GROUP_BITS = 31
ALL_ONES = np.uint32((1 << GROUP_BITS) - 1)  # 0x7FFFFFFF


def indices_to_groups(idx: np.ndarray) -> np.ndarray:
    """Sorted unique int64 indices -> dense group payload stream (uint32)."""
    idx = np.asarray(idx, dtype=np.int64)
    if idx.size == 0:
        return np.empty(0, dtype=np.uint32)
    gid = idx // GROUP_BITS
    bit = (idx % GROUP_BITS).astype(np.uint32)
    n_groups = int(gid[-1]) + 1
    payload = np.zeros(n_groups, dtype=np.uint32)
    np.bitwise_or.at(payload, gid, np.uint32(1) << bit)
    return payload


def groups_to_indices(payload: np.ndarray) -> np.ndarray:
    """Dense group payload stream -> sorted int64 indices."""
    if payload.size == 0:
        return np.empty(0, dtype=np.int64)
    nz = np.nonzero(payload)[0]
    if nz.size == 0:
        return np.empty(0, dtype=np.int64)
    bits = np.unpackbits(
        payload[nz].astype("<u4").view(np.uint8).reshape(-1, 4),
        axis=1, bitorder="little")[:, :GROUP_BITS]
    g, b = np.nonzero(bits)
    return (nz[g] * GROUP_BITS + b).astype(np.int64)


def pad_to(payload: np.ndarray, n: int) -> np.ndarray:
    if payload.size >= n:
        return payload
    out = np.zeros(n, dtype=np.uint32)
    out[: payload.size] = payload
    return out


def classify(payload: np.ndarray) -> np.ndarray:
    """0 = zero-fill group, 1 = ones-fill group, 2 = literal."""
    cls = np.full(payload.size, 2, dtype=np.int8)
    cls[payload == 0] = 0
    cls[payload == ALL_ONES] = 1
    return cls


def run_starts_and_lengths(cls: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """RLE over the class stream where every literal group is its own run."""
    n = cls.size
    if n == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    change = np.empty(n, dtype=bool)
    change[0] = True
    change[1:] = cls[1:] != cls[:-1]
    starts = np.nonzero(change | (cls == 2))[0]
    lengths = np.diff(np.append(starts, n))
    return starts, lengths


def split_long_runs(starts: np.ndarray, lengths: np.ndarray, cls_at_start: np.ndarray,
                    cap: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split homogeneous runs longer than the format's run-length capacity."""
    too_long = (lengths > cap) & (cls_at_start != 2)
    if not too_long.any():
        return starts, lengths, cls_at_start
    s_out, l_out, c_out = [], [], []
    for s, l, c in zip(starts.tolist(), lengths.tolist(), cls_at_start.tolist()):
        if c != 2 and l > cap:
            while l > 0:
                take = min(l, cap)
                s_out.append(s)
                l_out.append(take)
                c_out.append(c)
                s += take
                l -= take
        else:
            s_out.append(s)
            l_out.append(l)
            c_out.append(c)
    return (np.asarray(s_out, dtype=np.int64), np.asarray(l_out, dtype=np.int64),
            np.asarray(c_out, dtype=np.int8))
