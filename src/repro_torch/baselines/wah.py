"""WAH — Word Aligned Hybrid bitmap compression (Wu et al.), w = 32.

Format (paper S1): the bitmap is cut into 31-bit groups.
  * literal word: bit31 = 0, bits 0..30 = the heterogeneous group;
  * fill word:    bit31 = 1, bit30 = fill bit value, bits 0..29 = run length
    (number of consecutive homogeneous 31-bit groups, >= 1).

Sparse worst case: 2 words (64 bits) per set bit, as the paper notes.
"""

from __future__ import annotations

import numpy as np

from ._groups import (ALL_ONES, GROUP_BITS, classify, groups_to_indices,
                      indices_to_groups, pad_to, run_starts_and_lengths,
                      split_long_runs)

_FLAG = np.uint32(1) << np.uint32(31)
_FILL_ONE = np.uint32(1) << np.uint32(30)
_LEN_MASK = np.uint32((1 << 30) - 1)
RUN_CAP = (1 << 30) - 1


def encode_groups(payload: np.ndarray) -> np.ndarray:
    """Vectorized group-stream -> WAH words."""
    if payload.size == 0:
        return np.empty(0, dtype=np.uint32)
    cls = classify(payload)
    starts, lengths = run_starts_and_lengths(cls)
    cstart = cls[starts]
    starts, lengths, cstart = split_long_runs(starts, lengths, cstart, RUN_CAP)
    words = np.empty(starts.size, dtype=np.uint32)
    lit = cstart == 2
    words[lit] = payload[starts[lit]]
    fill = ~lit
    words[fill] = (_FLAG
                   | np.where(cstart[fill] == 1, _FILL_ONE, np.uint32(0))
                   | lengths[fill].astype(np.uint32))
    return words


def decode_groups(words: np.ndarray) -> np.ndarray:
    """Vectorized WAH words -> group stream."""
    if words.size == 0:
        return np.empty(0, dtype=np.uint32)
    is_fill = (words & _FLAG) != 0
    counts = np.where(is_fill, words & _LEN_MASK, 1).astype(np.int64)
    values = np.where(
        is_fill,
        np.where((words & _FILL_ONE) != 0, ALL_ONES, np.uint32(0)),
        words & _LEN_MASK | (words & (np.uint32(1) << np.uint32(30))),  # literal payload
    )
    # literal payload is simply bits 0..30:
    values = np.where(is_fill, values, words & np.uint32((1 << 31) - 1))
    return np.repeat(values, counts)


class WahBitmap:
    """WAH-compressed integer set."""

    __slots__ = ("words", "_max")

    def __init__(self, words: np.ndarray, max_value: int = -1):
        self.words = np.asarray(words, dtype=np.uint32)
        self._max = max_value

    # -- construction ---------------------------------------------------------
    @classmethod
    def from_array(cls, values) -> "WahBitmap":
        idx = np.asarray(sorted(set(int(v) for v in values)), dtype=np.int64)
        return cls.from_sorted_unique(idx)

    @classmethod
    def from_sorted_unique(cls, idx: np.ndarray) -> "WahBitmap":
        payload = indices_to_groups(np.asarray(idx, dtype=np.int64))
        mx = int(idx[-1]) if len(idx) else -1
        return cls(encode_groups(payload), mx)

    # -- queries ---------------------------------------------------------------
    def to_array(self) -> np.ndarray:
        return groups_to_indices(decode_groups(self.words))

    @property
    def cardinality(self) -> int:
        payload = decode_groups(self.words)
        return int(np.bitwise_count(payload).sum())

    def size_in_bytes(self) -> int:
        return 4 * int(self.words.size)

    # -- logical ops -------------------------------------------------------------
    def _binary(self, other: "WahBitmap", op) -> "WahBitmap":
        ga, gb = decode_groups(self.words), decode_groups(other.words)
        n = max(ga.size, gb.size)
        out = op(pad_to(ga, n), pad_to(gb, n))
        return WahBitmap(encode_groups(out), max(self._max, other._max))

    def and_(self, other: "WahBitmap") -> "WahBitmap":
        return self._binary(other, np.bitwise_and)

    def or_(self, other: "WahBitmap") -> "WahBitmap":
        return self._binary(other, np.bitwise_or)

    def and_streaming(self, other: "WahBitmap"):
        return _streaming_op(self.words, other.words, "and")

    def or_streaming(self, other: "WahBitmap"):
        return _streaming_op(self.words, other.words, "or")

    # -- single-element updates (Fig. 2e/2f) --------------------------------------
    def append(self, x: int) -> None:
        """Add x > max(S): operate on the tail of the word stream only —
        the efficient-append case WAH supports."""
        assert x > self._max, "append requires x greater than all elements"
        gid, bit = x // GROUP_BITS, x % GROUP_BITS
        last_gid = self._max // GROUP_BITS if self._max >= 0 else -1
        words = self.words
        if gid == last_gid and words.size:
            w = int(words[-1])
            if w & int(_FLAG):  # trailing fill of ones cannot contain last group w/ gap
                # split: reduce run by one, emit literal for last group
                run = w & int(_LEN_MASK)
                fill_one = bool(w & int(_FILL_ONE))
                payload = int(ALL_ONES) if fill_one else 0
                payload |= 1 << bit
                if run == 1:
                    words = words[:-1]
                else:
                    words = words.copy()
                    words[-1] = np.uint32((w & ~int(_LEN_MASK)) | (run - 1))
                self.words = np.append(words, np.uint32(payload))
            else:
                words = words.copy()
                words[-1] = np.uint32(w | (1 << bit))
                self.words = words
        else:
            gap = gid - last_gid - 1
            new = []
            while gap > 0:
                take = min(gap, RUN_CAP)
                new.append(int(_FLAG) | take)
                gap -= take
            new.append(1 << bit)
            self.words = np.append(self.words, np.asarray(new, dtype=np.uint32))
        self._max = x

    def remove(self, x: int) -> None:
        """RLE formats have no efficient random remove: full pass (decode,
        clear, re-encode) — this is exactly what the paper's Fig. 2f shows."""
        payload = decode_groups(self.words)
        gid, bit = x // GROUP_BITS, x % GROUP_BITS
        if gid < payload.size:
            payload[gid] &= np.uint32(~(1 << bit) & 0xFFFFFFFF)
            self.words = encode_groups(payload)
            if x == self._max:
                idx = groups_to_indices(payload)
                self._max = int(idx[-1]) if idx.size else -1

    def __eq__(self, other) -> bool:
        if not isinstance(other, WahBitmap):
            return NotImplemented
        return np.array_equal(self.to_array(), other.to_array())


def _streaming_op(wa: np.ndarray, wb: np.ndarray, kind: str):
    """Faithful run-at-a-time WAH merge (word-level control flow of the real
    algorithm). Returns (result_words, words_touched)."""
    out: list[int] = []
    touched = 0

    def runs(words):
        for w in words.tolist():
            w = int(w)
            if w & int(_FLAG):
                yield (w & int(_LEN_MASK)), (int(ALL_ONES) if w & int(_FILL_ONE) else 0)
            else:
                yield 1, w

    ita, itb = runs(wa), runs(wb)
    la = lb = 0
    va = vb = 0
    op = (lambda x, y: x & y) if kind == "and" else (lambda x, y: x | y)
    while True:
        if la == 0:
            nxt = next(ita, None)
            if nxt is None:
                break
            la, va = nxt
            touched += 1
        if lb == 0:
            nxt = next(itb, None)
            if nxt is None:
                break
            lb, vb = nxt
            touched += 1
        take = min(la, lb) if (va in (0, int(ALL_ONES)) and vb in (0, int(ALL_ONES))) else 1
        v = op(va, vb)
        # append run to output (merge with previous run when homogeneous)
        if v in (0, int(ALL_ONES)) and out and (out[-1][1] == v):
            out[-1][0] += take
        else:
            out.append([take, v])
        la -= take
        lb -= take
    # drain: OR keeps the remainder, AND drops it (zeros)
    if kind == "or":
        for it, l, v in ((ita, la, va), (itb, lb, vb)):
            if l:
                if v in (0, int(ALL_ONES)) and out and out[-1][1] == v:
                    out[-1][0] += l
                else:
                    out.append([l, v])
            for l2, v2 in it:
                touched += 1
                if v2 in (0, int(ALL_ONES)) and out and out[-1][1] == v2:
                    out[-1][0] += l2
                else:
                    out.append([l2, v2])
    words = []
    for l, v in out:
        if v in (0, int(ALL_ONES)) and l >= 1:
            one = int(_FILL_ONE) if v == int(ALL_ONES) else 0
            while l > 0:
                take = min(l, RUN_CAP)
                words.append(int(_FLAG) | one | take)
                l -= take
        else:
            words.extend([v] * l)
    return WahBitmap(np.asarray(words, dtype=np.uint32)), touched
