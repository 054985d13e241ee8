"""Concise — Compressed 'n' Composable Integer Set (Colantonio & Di Pietro).

Format (paper S1, w = 32): like WAH but fill words sacrifice
ceil(log2 w) = 5 bits of the run length as *position bits*:

  * literal: bit31 = 0, bits 0..30 payload;
  * fill:    bit31 = 1, bit30 = fill bit, bits 25..29 = position p,
             bits 0..24 = run length r.
    p = 0  -> r+1 homogeneous 31-bit groups;
    p > 0  -> one group equal to the fill value with bit (p-1) flipped,
              followed by r homogeneous groups.

The mixed fill is what halves WAH's 64 bits/int worst case to 32 bits/int on
sets like {0, 62, 124, ...}.
"""

from __future__ import annotations

import numpy as np

from ._groups import (ALL_ONES, GROUP_BITS, classify, groups_to_indices,
                      indices_to_groups, pad_to, run_starts_and_lengths)

_FLAG = 1 << 31
_FILL_ONE = 1 << 30
_POS_SHIFT = 25
_POS_MASK = 0x1F
_LEN_MASK = (1 << 25) - 1
RUN_CAP = (1 << 25) - 1           # max r; one fill word covers r+1 groups
MAX_GROUPS_PER_WORD = RUN_CAP + 1


def _emit_pure_fill(out: list, fill_one: bool, n_groups: int) -> None:
    """Emit fill words covering n_groups homogeneous groups."""
    base = _FLAG | (_FILL_ONE if fill_one else 0)
    while n_groups > 0:
        take = min(n_groups, MAX_GROUPS_PER_WORD)
        out.append(base | (take - 1))
        n_groups -= take


def encode_groups(payload: np.ndarray) -> np.ndarray:
    """Group stream -> Concise words, merging single-flipped-bit literals into
    the following fill run (the format's signature optimization)."""
    if payload.size == 0:
        return np.empty(0, dtype=np.uint32)
    cls = classify(payload)
    starts, lengths = run_starts_and_lengths(cls)
    cstart = cls[starts].tolist()
    starts_l = starts.tolist()
    lengths_l = lengths.tolist()
    out: list[int] = []
    n = len(starts_l)
    i = 0
    while i < n:
        c, s, l = cstart[i], starts_l[i], lengths_l[i]
        if c == 2:  # literal group
            w = int(payload[s])
            pc = int(w).bit_count()
            merged = False
            if i + 1 < n and cstart[i + 1] in (0, 1):
                fill_one = cstart[i + 1] == 1
                nxt_len = lengths_l[i + 1]
                if (not fill_one and pc == 1) or (fill_one and pc == GROUP_BITS - 1):
                    if fill_one:
                        flipped = (~w) & int(ALL_ONES)
                    else:
                        flipped = w
                    p = int(flipped).bit_length()  # index of the single bit + 1
                    r = min(nxt_len, RUN_CAP)
                    out.append(_FLAG | (_FILL_ONE if fill_one else 0)
                               | (p << _POS_SHIFT) | r)
                    rest = nxt_len - r
                    if rest > 0:
                        _emit_pure_fill(out, fill_one, rest)
                    i += 2
                    merged = True
            if not merged:
                out.append(w)
                i += 1
        else:
            _emit_pure_fill(out, c == 1, l)
            i += 1
    return np.asarray(out, dtype=np.uint32)


def decode_groups(words: np.ndarray) -> np.ndarray:
    """Concise words -> dense group stream (vectorized)."""
    if words.size == 0:
        return np.empty(0, dtype=np.uint32)
    w = words.astype(np.int64)
    is_fill = (w & _FLAG) != 0
    fill_one = (w & _FILL_ONE) != 0
    pos = (w >> _POS_SHIFT) & _POS_MASK
    pos = np.where(is_fill, pos, 0)
    # every fill word covers r+1 groups: r fills preceded by one flipped word
    # when p > 0, or r+1 plain fills when p = 0 (paper S1).
    counts = np.where(is_fill, (w & _LEN_MASK) + 1, 1).astype(np.int64)
    values = np.where(is_fill,
                      np.where(fill_one, np.int64(int(ALL_ONES)), np.int64(0)),
                      w & int(ALL_ONES)).astype(np.int64)
    payload = np.repeat(values, counts).astype(np.uint32)
    # fix flipped first group of mixed fills
    mixed = is_fill & (pos > 0)
    if mixed.any():
        starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
        mstarts = starts[mixed]
        mbits = (pos[mixed] - 1).astype(np.uint32)
        payload[mstarts] ^= np.uint32(1) << mbits
    return payload


class ConciseBitmap:
    """Concise-compressed integer set."""

    __slots__ = ("words", "_max")

    def __init__(self, words: np.ndarray, max_value: int = -1):
        self.words = np.asarray(words, dtype=np.uint32)
        self._max = max_value

    @classmethod
    def from_array(cls, values) -> "ConciseBitmap":
        idx = np.asarray(sorted(set(int(v) for v in values)), dtype=np.int64)
        return cls.from_sorted_unique(idx)

    @classmethod
    def from_sorted_unique(cls, idx: np.ndarray) -> "ConciseBitmap":
        payload = indices_to_groups(np.asarray(idx, dtype=np.int64))
        mx = int(idx[-1]) if len(idx) else -1
        return cls(encode_groups(payload), mx)

    def to_array(self) -> np.ndarray:
        return groups_to_indices(decode_groups(self.words))

    @property
    def cardinality(self) -> int:
        return int(np.bitwise_count(decode_groups(self.words)).sum())

    def size_in_bytes(self) -> int:
        return 4 * int(self.words.size)

    def _binary(self, other: "ConciseBitmap", op) -> "ConciseBitmap":
        ga, gb = decode_groups(self.words), decode_groups(other.words)
        n = max(ga.size, gb.size)
        out = op(pad_to(ga, n), pad_to(gb, n))
        return ConciseBitmap(encode_groups(out), max(self._max, other._max))

    def and_(self, other: "ConciseBitmap") -> "ConciseBitmap":
        return self._binary(other, np.bitwise_and)

    def or_(self, other: "ConciseBitmap") -> "ConciseBitmap":
        return self._binary(other, np.bitwise_or)

    # -- single-element updates ---------------------------------------------------
    def append(self, x: int) -> None:
        """Add x > max(S), operating on the stream tail only."""
        assert x > self._max
        gid, bit = x // GROUP_BITS, x % GROUP_BITS
        last_gid = self._max // GROUP_BITS if self._max >= 0 else -1
        out = self.words.tolist()
        if gid == last_gid and out:
            w = int(out[-1])
            if not (w & _FLAG):
                out[-1] = w | (1 << bit)
            else:
                # tail is a fill covering this group: split its last group off
                payload = int(ALL_ONES) if (w & _FILL_ONE) else 0
                r = w & _LEN_MASK
                if r == 0 and not ((w >> _POS_SHIFT) & _POS_MASK):
                    out.pop()
                else:
                    out[-1] = w - 1 if r > 0 else w
                out.append(payload | (1 << bit))
        else:
            gap = gid - last_gid - 1
            if gap > 0:
                lit_is_single = out and not (int(out[-1]) & _FLAG) \
                    and int(out[-1]).bit_count() == 1
                if lit_is_single and gap - 1 <= RUN_CAP:
                    p = int(out[-1]).bit_length()
                    out[-1] = _FLAG | (p << _POS_SHIFT) | gap
                    # covers literal + gap groups: r = gap, total gap+1  ... but we
                    # need literal + gap zero groups = gap+1 groups -> r = gap. OK.
                else:
                    tmp: list[int] = []
                    _emit_pure_fill(tmp, False, gap)
                    out.extend(tmp)
            out.append(1 << bit)
        self.words = np.asarray(out, dtype=np.uint32)
        self._max = x

    def remove(self, x: int) -> None:
        """Full-pass decode/modify/encode — RLE formats lack random removal."""
        payload = decode_groups(self.words)
        gid, bit = x // GROUP_BITS, x % GROUP_BITS
        if gid < payload.size:
            payload[gid] &= np.uint32(~(1 << bit) & 0xFFFFFFFF)
            self.words = encode_groups(payload)
            if x == self._max:
                idx = groups_to_indices(payload)
                self._max = int(idx[-1]) if idx.size else -1

    def __eq__(self, other) -> bool:
        if not isinstance(other, ConciseBitmap):
            return NotImplemented
        return np.array_equal(self.to_array(), other.to_array())
