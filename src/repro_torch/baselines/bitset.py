"""Uncompressed bitmap mirroring java.util.BitSet.

Key behavioural detail reproduced from the paper's S5.1: BitSet *doubles* the
backing array whenever it grows, so the measured footprint of an incrementally
built set exceeds the trimmed size (visible in Fig. 2a/2b as BitSet sitting
slightly above 64/d even on dense data). Bulk construction allocates exactly;
`append` follows the doubling policy. Logical ops are in-place in Java, so the
benchmarked op includes a `clone`, as in the paper.
"""

from __future__ import annotations

import numpy as np


class BitSet:
    __slots__ = ("words", "words_in_use")

    def __init__(self, words: np.ndarray | None = None):
        self.words = words if words is not None else np.zeros(1, dtype=np.uint64)
        self.words_in_use = int(self.words.size)

    @classmethod
    def from_array(cls, values) -> "BitSet":
        idx = np.asarray(sorted(set(int(v) for v in values)), dtype=np.int64)
        return cls.from_sorted_unique(idx)

    @classmethod
    def from_sorted_unique(cls, idx: np.ndarray) -> "BitSet":
        idx = np.asarray(idx, dtype=np.int64)
        n_words = (int(idx[-1]) >> 6) + 1 if idx.size else 1
        words = np.zeros(n_words, dtype=np.uint64)
        np.bitwise_or.at(words, idx >> 6,
                         np.uint64(1) << (idx & 63).astype(np.uint64))
        return cls(words)

    def _ensure(self, n_words: int) -> None:
        if n_words > self.words.size:
            new_size = max(2 * self.words.size, n_words)  # java doubling policy
            grown = np.zeros(new_size, dtype=np.uint64)
            grown[: self.words.size] = self.words
            self.words = grown
        self.words_in_use = max(self.words_in_use, n_words)

    def add(self, x: int) -> None:
        self._ensure((x >> 6) + 1)
        self.words[x >> 6] |= np.uint64(1) << np.uint64(x & 63)

    append = add

    def remove(self, x: int) -> None:
        if (x >> 6) < self.words.size:
            self.words[x >> 6] &= ~(np.uint64(1) << np.uint64(x & 63))

    def contains(self, x: int) -> bool:
        w = x >> 6
        return w < self.words.size and bool((int(self.words[w]) >> (x & 63)) & 1)

    def clone(self) -> "BitSet":
        b = BitSet(self.words.copy())
        b.words_in_use = self.words_in_use
        return b

    def and_(self, other: "BitSet") -> "BitSet":
        """clone + in-place AND, matching the paper's measurement protocol."""
        out = self.clone()
        n = min(out.words.size, other.words.size)
        np.bitwise_and(out.words[:n], other.words[:n], out=out.words[:n])
        out.words[n:] = 0
        return out

    def or_(self, other: "BitSet") -> "BitSet":
        small, large = (self, other) if self.words.size <= other.words.size else (other, self)
        out = large.clone()
        n = small.words.size
        np.bitwise_or(out.words[:n], small.words[:n], out=out.words[:n])
        return out

    def to_array(self) -> np.ndarray:
        bits = np.unpackbits(self.words.view(np.uint8), bitorder="little")
        return np.nonzero(bits)[0].astype(np.int64)

    @property
    def cardinality(self) -> int:
        return int(np.bitwise_count(self.words).sum())

    def size_in_bytes(self) -> int:
        """Allocated footprint (doubling included), as measured in the paper."""
        return 8 * int(self.words.size)

    def trimmed_size_in_bytes(self) -> int:
        nz = np.nonzero(self.words)[0]
        return 8 * (int(nz[-1]) + 1) if nz.size else 8

    def __eq__(self, other) -> bool:
        if not isinstance(other, BitSet):
            return NotImplemented
        return np.array_equal(self.to_array(), other.to_array())
