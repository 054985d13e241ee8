"""Paper-faithful Roaring bitmap (Chambi, Lemire, Kaser, Godin 2014).

This module is the *reproduction floor*: a CPU implementation that follows the
paper's data layout and Algorithms 1-4 exactly:

  * two-level index: sorted 16-bit keys -> containers of the low 16 bits;
  * array containers (sorted packed u16, card <= 4096) vs bitmap containers
    (2^16-bit bitmap as 1024 x u64, card > 4096);
  * run containers (sorted ``(start, length-1)`` u16 pairs, per the follow-up
    paper *Consistently faster and smaller compressed bitmaps with Roaring*,
    Lemire, Ssi-Yan-Kai & Kaser 2016), chosen by the ``runOptimize``
    best-of-three serialized-size rule;
  * per-container cardinality counters;
  * hybrid AND/OR per container-type pair, including the cardinality-first
    bitmap AND (Alg. 3), fused popcount union (Alg. 1), galloping array
    intersection with the 64x ratio rule, and the union-through-bitmap rule;
  * full cross-kind algebra over the 3x3 container-type grid via the
    declarative ``_AND/_OR/_XOR/_ANDNOT`` pair-dispatch tables (the oracle
    mirror of the slab layer's kind-dispatch engine);
  * Alg. 2 set-bit extraction (both the faithful ``w & -w`` loop and a
    vectorized equivalent);
  * Alg. 4 many-way union with a key min-heap and deferred cardinality.

Canonical discipline: ``RoaringBitmap`` *set-algebra outputs* are always
best-of-three canonical (array vs bitmap vs run by serialized size — the 2016
paper's ``runOptimize`` applied eagerly), which is what makes this module the
bit-identical kind reference for ``torch_roaring``. Bulk constructors
(`from_sorted_unique`) and the 2014 add/remove dynamics keep the original
2-kind behavior; runs enter via ``from_ranges`` / ``run_optimize`` / op
outputs.

NumPy stands in for 64-bit words + popcnt (``np.bitwise_count``), mirroring
how the paper's Java implementation leans on ``Long.bitCount``.

The static-shape device slab lives in ``torch_roaring.py``; its CUDA
kernels in ``repro_torch.kernels.roaring``.
"""

from __future__ import annotations

import heapq
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

# --- constants from the paper ------------------------------------------------
CHUNK_BITS = 16
CHUNK_SIZE = 1 << CHUNK_BITS              # 2^16 integers per chunk
ARRAY_MAX = 4096                          # array container max cardinality
BITMAP_WORDS = CHUNK_SIZE // 64           # 1024 x u64 words per bitmap container
GALLOP_RATIO = 64                         # merge vs galloping threshold (S4)

_U16 = np.uint16
_U64 = np.uint64


# =============================================================================
# Word-level primitives (Algorithm 2 and friends)
# =============================================================================

def popcount_words(words: np.ndarray) -> int:
    """Hamming weight of a word array — the paper's popcnt/Long.bitCount."""
    return int(np.bitwise_count(words).sum())


def extract_set_bits_faithful(w: int, base: int, out: List[int]) -> None:
    """Algorithm 2, verbatim: emit positions of set bits in one 64-bit word.

    Uses two's-complement tricks ``t = w & -w`` (isolate lowest bit) and
    ``w &= w - 1`` (clear lowest bit); cf. Warren, Hacker's Delight.
    """
    w &= (1 << 64) - 1
    while w != 0:
        t = w & (-w & ((1 << 64) - 1))
        out.append(base + int(t - 1).bit_count())
        w &= w - 1


def bitmap_to_array_faithful(words: np.ndarray) -> np.ndarray:
    """Convert bitmap words to a sorted u16 array via Algorithm 2 (loop form)."""
    out: List[int] = []
    for i, w in enumerate(words.tolist()):
        if w:
            extract_set_bits_faithful(int(w), i * 64, out)
    return np.asarray(out, dtype=_U16)


def bitmap_to_array(words: np.ndarray) -> np.ndarray:
    """Vectorized Algorithm 2: positions of all set bits, ascending.

    Equivalent output to the faithful loop; uses byte unpacking + nonzero,
    which is the numpy analogue of extracting with popcount offsets.
    """
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.nonzero(bits)[0].astype(_U16)


def array_to_bitmap(arr: np.ndarray) -> np.ndarray:
    """Set the bits of a sorted u16 array in a fresh 1024-word bitmap
    (one byte per bit, packed little-endian: bit v lands in word v >> 6 at
    position v & 63)."""
    bits = np.zeros(CHUNK_SIZE, dtype=np.uint8)
    bits[np.asarray(arr, dtype=np.intp)] = 1
    return np.packbits(bits, bitorder="little").view("<u8").astype(_U64)


# =============================================================================
# Containers
# =============================================================================

class ArrayContainer:
    """Sorted packed array of 16-bit integers, cardinality <= 4096."""

    __slots__ = ("arr",)

    def __init__(self, arr: Optional[np.ndarray] = None):
        self.arr = (
            np.empty(0, dtype=_U16) if arr is None else np.asarray(arr, dtype=_U16)
        )

    @property
    def cardinality(self) -> int:
        return int(self.arr.size)

    def size_in_bytes(self) -> int:
        return 2 * self.arr.size  # 16 bits per integer

    def contains(self, x: int) -> bool:
        i = int(np.searchsorted(self.arr, _U16(x)))
        return i < self.arr.size and int(self.arr[i]) == x

    def clone(self) -> "ArrayContainer":
        return ArrayContainer(self.arr.copy())

    def add(self, x: int) -> "Container":
        """Binary search + linear-time insertion; convert at >4096 (S3)."""
        i = int(np.searchsorted(self.arr, _U16(x)))
        if i < self.arr.size and int(self.arr[i]) == x:
            return self
        self.arr = np.insert(self.arr, i, _U16(x))
        if self.arr.size > ARRAY_MAX:
            return BitmapContainer(array_to_bitmap(self.arr), self.arr.size)
        return self

    def remove(self, x: int) -> "Container":
        i = int(np.searchsorted(self.arr, _U16(x)))
        if i < self.arr.size and int(self.arr[i]) == x:
            self.arr = np.delete(self.arr, i)
        return self

    def to_array(self) -> np.ndarray:
        return self.arr

    def iter_values(self) -> Iterator[int]:
        return iter(self.arr.tolist())


class BitmapContainer:
    """2^16-bit bitmap (1024 x u64) with a tracked cardinality counter."""

    __slots__ = ("words", "cardinality")

    def __init__(self, words: Optional[np.ndarray] = None, cardinality: int = -1):
        self.words = (
            np.zeros(BITMAP_WORDS, dtype=_U64)
            if words is None
            else np.asarray(words, dtype=_U64)
        )
        self.cardinality = (
            popcount_words(self.words) if cardinality < 0 else int(cardinality)
        )

    def size_in_bytes(self) -> int:
        return 8 * BITMAP_WORDS  # always 8 kB

    def contains(self, x: int) -> bool:
        return bool((int(self.words[x >> 6]) >> (x & 63)) & 1)

    def clone(self) -> "BitmapContainer":
        return BitmapContainer(self.words.copy(), self.cardinality)

    def add(self, x: int) -> "Container":
        w = int(self.words[x >> 6])
        bit = 1 << (x & 63)
        if not (w & bit):
            self.words[x >> 6] = _U64(w | bit)
            self.cardinality += 1
        return self

    def remove(self, x: int) -> "Container":
        """Clear a bit; convert to array when cardinality reaches 4096 (S3)."""
        w = int(self.words[x >> 6])
        bit = 1 << (x & 63)
        if w & bit:
            self.words[x >> 6] = _U64(w & ~bit)
            self.cardinality -= 1
            if self.cardinality <= ARRAY_MAX:
                return ArrayContainer(bitmap_to_array(self.words))
        return self

    def to_array(self) -> np.ndarray:
        return bitmap_to_array(self.words)

    def iter_values(self) -> Iterator[int]:
        return iter(self.to_array().tolist())


def runs_from_array(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted unique values -> (starts, lengths-1) of maximal runs."""
    a = np.asarray(arr, dtype=np.int64)
    if a.size == 0:
        return (np.empty(0, np.int64), np.empty(0, np.int64))
    brk = np.nonzero(np.diff(a) != 1)[0]
    starts = a[np.concatenate(([0], brk + 1))]
    ends = a[np.concatenate((brk, [a.size - 1]))]
    return starts, ends - starts


class RunContainer:
    """Sorted, disjoint, non-adjacent runs of consecutive 16-bit integers.

    The 2016 paper's third container kind: run ``i`` covers
    ``[starts[i], starts[i] + lengths[i]]`` (``lengths`` stores length-1, the
    serialized u16 format — a single run of all 2^16 values is
    ``(0, 0xFFFF)``). Serialized size is 4 bytes per run.
    """

    __slots__ = ("starts", "lengths")

    def __init__(self, starts: Optional[np.ndarray] = None,
                 lengths: Optional[np.ndarray] = None):
        self.starts = (np.empty(0, np.int64) if starts is None
                       else np.asarray(starts, dtype=np.int64))
        self.lengths = (np.empty(0, np.int64) if lengths is None
                        else np.asarray(lengths, dtype=np.int64))

    @property
    def n_runs(self) -> int:
        return int(self.starts.size)

    @property
    def cardinality(self) -> int:
        return int(self.lengths.sum() + self.starts.size)

    def size_in_bytes(self) -> int:
        return 4 * self.n_runs  # two u16 per run

    def contains(self, x: int) -> bool:
        i = int(np.searchsorted(self.starts, x, side="right")) - 1
        return i >= 0 and x <= int(self.starts[i] + self.lengths[i])

    def clone(self) -> "RunContainer":
        return RunContainer(self.starts.copy(), self.lengths.copy())

    def rank(self, low: int) -> int:
        """# of elements <= low (the run analogue of the partial popcount)."""
        i = int(np.searchsorted(self.starts, low, side="right"))
        full = int((self.lengths[:i] + 1).sum())
        if i > 0:
            e = int(self.starts[i - 1] + self.lengths[i - 1])
            full -= max(0, e - low)
        return full

    def add(self, x: int) -> "Container":
        """Insert one value: extend/merge runs; re-canonicalize by size."""
        if self.contains(x):
            return self
        i = int(np.searchsorted(self.starts, x, side="right")) - 1
        touch_prev = i >= 0 and int(self.starts[i] + self.lengths[i]) == x - 1
        touch_next = (i + 1 < self.n_runs and int(self.starts[i + 1]) == x + 1)
        if touch_prev and touch_next:
            self.lengths[i] += self.lengths[i + 1] + 2
            self.starts = np.delete(self.starts, i + 1)
            self.lengths = np.delete(self.lengths, i + 1)
        elif touch_prev:
            self.lengths[i] += 1
        elif touch_next:
            self.starts[i + 1] -= 1
            self.lengths[i + 1] += 1
        else:
            self.starts = np.insert(self.starts, i + 1, x)
            self.lengths = np.insert(self.lengths, i + 1, 0)
        return _canonical(self)

    def remove(self, x: int) -> "Container":
        """Delete one value: trim/split runs; re-canonicalize by size."""
        i = int(np.searchsorted(self.starts, x, side="right")) - 1
        if i < 0 or x > int(self.starts[i] + self.lengths[i]):
            return self
        s, e = int(self.starts[i]), int(self.starts[i] + self.lengths[i])
        if s == e:                                   # singleton run
            self.starts = np.delete(self.starts, i)
            self.lengths = np.delete(self.lengths, i)
        elif x == s:
            self.starts[i] += 1
            self.lengths[i] -= 1
        elif x == e:
            self.lengths[i] -= 1
        else:                                        # split
            self.starts = np.insert(self.starts, i + 1, x + 1)
            self.lengths = np.insert(self.lengths, i + 1, e - x - 1)
            self.lengths[i] = x - 1 - s
        return _canonical(self)

    def to_array(self) -> np.ndarray:
        if self.n_runs == 0:
            return np.empty(0, dtype=_U16)
        parts = [np.arange(s, s + l + 1)
                 for s, l in zip(self.starts.tolist(), self.lengths.tolist())]
        return np.concatenate(parts).astype(_U16)

    def to_bitmap_words(self) -> np.ndarray:
        """Run coverage as 1024 u64 words (the range-mask lift)."""
        flags = np.zeros(CHUNK_SIZE + 1, dtype=np.int8)
        np.add.at(flags, self.starts, 1)
        np.add.at(flags, self.starts + self.lengths + 1, -1)
        bits = np.cumsum(flags[:CHUNK_SIZE]) > 0
        return np.packbits(bits, bitorder="little").view(_U64)

    def iter_values(self) -> Iterator[int]:
        for s, l in zip(self.starts.tolist(), self.lengths.tolist()):
            yield from range(s, s + l + 1)


Container = Union[ArrayContainer, BitmapContainer, RunContainer]


def n_runs_of(c: Container) -> int:
    """Number of maximal runs a container's value set splits into."""
    if isinstance(c, RunContainer):
        return c.n_runs
    if isinstance(c, BitmapContainer):
        # rising-edge popcount: a run starts where a bit is set and its
        # predecessor is clear — O(1024 words), no value materialization
        w = c.words
        carry = np.concatenate(([_U64(0)], w[:-1] >> _U64(63)))
        rising = w & ~((w << _U64(1)) | carry)
        return int(np.bitwise_count(rising).sum())
    arr = c.arr
    if arr.size == 0:
        return 0
    return int(np.count_nonzero(np.diff(arr.astype(np.int64)) != 1)) + 1


def _canonical(c: Container) -> Container:
    """``runOptimize`` best-of-three: pick array vs bitmap vs run by strict
    serialized size (2*card vs 8192 vs 4*n_runs); run only when strictly
    smaller, array preferred at the 4096 tie (paper: > 4096 converts)."""
    card = c.cardinality
    if card == 0:
        return ArrayContainer()
    nr = n_runs_of(c)
    other = min(2 * card, 8 * BITMAP_WORDS) if card <= ARRAY_MAX \
        else 8 * BITMAP_WORDS
    if 4 * nr < other:
        if isinstance(c, RunContainer):
            return c
        arr = c.arr if isinstance(c, ArrayContainer) else c.to_array()
        return RunContainer(*runs_from_array(arr))
    if card <= ARRAY_MAX:
        if isinstance(c, ArrayContainer):
            return c
        return ArrayContainer(c.to_array())
    if isinstance(c, BitmapContainer):
        return c
    if isinstance(c, RunContainer):
        return BitmapContainer(c.to_bitmap_words(), card)
    return BitmapContainer(array_to_bitmap(c.arr), card)


def _maybe_to_array(c: BitmapContainer) -> Container:
    if c.cardinality <= ARRAY_MAX:
        return ArrayContainer(bitmap_to_array(c.words))
    return c


def _words_of(c: Container) -> np.ndarray:
    if isinstance(c, BitmapContainer):
        return c.words
    if isinstance(c, RunContainer):
        return c.to_bitmap_words()
    return array_to_bitmap(c.arr)


# =============================================================================
# Container-pair logical operations (paper S4)
# =============================================================================

def union_bitmap_bitmap(a: BitmapContainer, b: BitmapContainer) -> BitmapContainer:
    """Algorithm 1: 1024 ORs with fused popcount; result stays a bitmap
    (cardinality >= max(|A|,|B|) > 4096)."""
    words = np.bitwise_or(a.words, b.words)
    return BitmapContainer(words, popcount_words(words))


def union_bitmap_bitmap_inplace(a: BitmapContainer, b: BitmapContainer) -> BitmapContainer:
    """In-place variant (S4): overwrite A, skip cardinality until asked."""
    np.bitwise_or(a.words, b.words, out=a.words)
    a.cardinality = popcount_words(a.words)
    return a


def intersect_bitmap_bitmap(a: BitmapContainer, b: BitmapContainer) -> Container:
    """Algorithm 3: compute cardinality first with 1024 ANDs + popcount, then
    materialize a bitmap (card > 4096) or extract an array (Alg. 2)."""
    anded = np.bitwise_and(a.words, b.words)
    c = popcount_words(anded)
    if c > ARRAY_MAX:
        return BitmapContainer(anded, c)
    return ArrayContainer(bitmap_to_array(anded))


def union_array_bitmap(a: ArrayContainer, b: BitmapContainer) -> BitmapContainer:
    """Clone the bitmap and set the array's bits (S4 Bitmap vs Array)."""
    out = b.clone()
    idx = a.arr.astype(np.int64)
    words = out.words
    # cardinality update by counting newly-set bits (paper: check whether the
    # word value was modified); array elements are unique, so the number of
    # new bits is the number of elements not already present.
    present = (words[idx >> 6] >> (idx & 63).astype(_U64)) & _U64(1)
    np.bitwise_or.at(words, idx >> 6, (_U64(1) << (idx & 63).astype(_U64)))
    out.cardinality = b.cardinality + int(idx.size - int(present.sum()))
    return out


def intersect_array_bitmap(a: ArrayContainer, b: BitmapContainer) -> ArrayContainer:
    """Probe each array element against the bitmap (S4); output is an array
    (cannot exceed |A| <= 4096)."""
    idx = a.arr.astype(np.int64)
    hits = (b.words[idx >> 6] >> (idx & 63).astype(_U64)) & _U64(1)
    return ArrayContainer(a.arr[hits.astype(bool)])


def _merge_intersect(small: np.ndarray, large: np.ndarray) -> np.ndarray:
    """Vectorized sorted-merge intersection (the paper's merge path)."""
    pos = np.searchsorted(large, small)
    pos_clipped = np.minimum(pos, large.size - 1)
    mask = (pos < large.size) & (large[pos_clipped] == small)
    return small[mask]


def galloping_intersect_faithful(r: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Faithful galloping (S4): for each r_i, exponential search in f then
    binary search — skips comparisons when |r| << |f|."""
    out: List[int] = []
    j = 0
    fl = f.tolist()
    n = len(fl)
    for ri in r.tolist():
        # exponential (galloping) phase
        step = 1
        lo = j
        hi = j + 1
        while hi < n and fl[hi] < ri:
            lo = hi
            hi = min(n, hi + step)
            step <<= 1
        # binary search phase in (lo, hi]
        hi = min(hi, n - 1)
        import bisect

        j = bisect.bisect_left(fl, ri, lo, min(hi + 1, n))
        if j < n and fl[j] == ri:
            out.append(ri)
    return np.asarray(out, dtype=_U16)


def intersect_array_array(a: ArrayContainer, b: ArrayContainer) -> ArrayContainer:
    """Merge when cardinalities within 64x, galloping otherwise (S4).

    Production path uses vectorized binary search for both regimes (numpy's
    searchsorted); `galloping_intersect_faithful` preserves the paper's exact
    control flow for validation.
    """
    small, large = (a.arr, b.arr) if a.arr.size <= b.arr.size else (b.arr, a.arr)
    if small.size == 0:
        return ArrayContainer()
    return ArrayContainer(_merge_intersect(small, large))


def union_array_array(a: ArrayContainer, b: ArrayContainer) -> Container:
    """S4 Array vs Array union: merge when sum <= 4096; otherwise set bits in
    a bitmap, popcount, and convert back down if the true card <= 4096."""
    total = a.arr.size + b.arr.size
    if total <= ARRAY_MAX:
        return ArrayContainer(np.union1d(a.arr, b.arr).astype(_U16))
    words = array_to_bitmap(a.arr)
    idx = b.arr.astype(np.int64)
    np.bitwise_or.at(words, idx >> 6, (_U64(1) << (idx & 63).astype(_U64)))
    c = popcount_words(words)
    if c <= ARRAY_MAX:
        return ArrayContainer(bitmap_to_array(words))
    return BitmapContainer(words, c)


def intersect_run_run(a: RunContainer, b: RunContainer) -> RunContainer:
    """Run-merge intersection (2016 paper): two-pointer sweep over the two
    sorted run lists; each output run is the overlap of one pair."""
    starts: List[int] = []
    lengths: List[int] = []
    i = j = 0
    na, nb = a.n_runs, b.n_runs
    while i < na and j < nb:
        sa, ea = int(a.starts[i]), int(a.starts[i] + a.lengths[i])
        sb, eb = int(b.starts[j]), int(b.starts[j] + b.lengths[j])
        s, e = max(sa, sb), min(ea, eb)
        if s <= e:
            starts.append(s)
            lengths.append(e - s)
        if ea <= eb:            # the run that closes first advances
            i += 1
        else:
            j += 1
    return RunContainer(np.asarray(starts, np.int64),
                        np.asarray(lengths, np.int64))


def union_run_run(a: RunContainer, b: RunContainer) -> RunContainer:
    """Run-merge union: merge the two sorted run lists, coalescing overlap
    and adjacency as we go."""
    starts: List[int] = []
    lengths: List[int] = []
    i = j = 0
    na, nb = a.n_runs, b.n_runs
    while i < na or j < nb:
        if j >= nb or (i < na and int(a.starts[i]) <= int(b.starts[j])):
            s, e = int(a.starts[i]), int(a.starts[i] + a.lengths[i])
            i += 1
        else:
            s, e = int(b.starts[j]), int(b.starts[j] + b.lengths[j])
            j += 1
        if starts and s <= int(starts[-1]) + int(lengths[-1]) + 1:
            lengths[-1] = max(lengths[-1], e - starts[-1])
        else:
            starts.append(s)
            lengths.append(e - s)
    return RunContainer(np.asarray(starts, np.int64),
                        np.asarray(lengths, np.int64))


def intersect_run_array(r: RunContainer, a: ArrayContainer) -> ArrayContainer:
    """Gallop-in-ranges: each array value binary-searches the run starts
    (S4's galloping adapted to interval endpoints)."""
    if a.arr.size == 0 or r.n_runs == 0:
        return ArrayContainer()
    v = a.arr.astype(np.int64)
    i = np.searchsorted(r.starts, v, side="right") - 1
    ic = np.maximum(i, 0)
    hit = (i >= 0) & (v <= r.starts[ic] + r.lengths[ic])
    return ArrayContainer(a.arr[hit])


def intersect_run_bitmap(r: RunContainer, b: BitmapContainer) -> Container:
    """Range-mask: AND the bitmap words with the run coverage (Alg. 3 with a
    synthesized operand), then materialize by the 4096 rule."""
    return _materialize_words(np.bitwise_and(r.to_bitmap_words(), b.words))


def _materialize_words(words: np.ndarray) -> Container:
    """Word-domain result -> container by the 4096 rule (Alg. 3 tail)."""
    c = popcount_words(words)
    if c > ARRAY_MAX:
        return BitmapContainer(words, c)
    return ArrayContainer(bitmap_to_array(words))


def _andnot_words(a: Container, b: Container) -> Container:
    return _materialize_words(
        np.bitwise_and(_words_of(a), np.bitwise_not(_words_of(b))))


def andnot_array_any(a: ArrayContainer, b: Container) -> ArrayContainer:
    """A \\ B with array A: probe each value of A in B (any B kind)."""
    if a.arr.size == 0:
        return ArrayContainer()
    if isinstance(b, ArrayContainer):
        if b.arr.size == 0:
            return ArrayContainer(a.arr.copy())
        pos = np.searchsorted(b.arr, a.arr)
        pos_c = np.minimum(pos, b.arr.size - 1)
        mask = (pos < b.arr.size) & (b.arr[pos_c] == a.arr)
        return ArrayContainer(a.arr[~mask])
    if isinstance(b, BitmapContainer):
        idx = a.arr.astype(np.int64)
        hits = (b.words[idx >> 6] >> (idx & 63).astype(_U64)) & _U64(1)
        return ArrayContainer(a.arr[~hits.astype(bool)])
    if b.n_runs == 0:
        return ArrayContainer(a.arr.copy())
    v = a.arr.astype(np.int64)
    i = np.searchsorted(b.starts, v, side="right") - 1
    ic = np.maximum(i, 0)
    keep = ~((i >= 0) & (v <= b.starts[ic] + b.lengths[ic]))
    return ArrayContainer(a.arr[keep])


def _xor_words(a: Container, b: Container) -> Container:
    return _materialize_words(np.bitwise_xor(_words_of(a), _words_of(b)))


def _or_words(a: Container, b: Container) -> Container:
    return _materialize_words(np.bitwise_or(_words_of(a), _words_of(b)))


# --- declarative pair-dispatch tables (the oracle mirror of the slab
# engine's kind-dispatch registry): keyed by (type_a, type_b); ``swap``-style
# symmetric entries are generated, so adding a 4th kind is new rows, not new
# branch chains. -------------------------------------------------------------

_A, _B, _R = ArrayContainer, BitmapContainer, RunContainer

_AND_TABLE = {
    (_A, _A): intersect_array_array,
    (_A, _B): intersect_array_bitmap,
    (_B, _A): lambda a, b: intersect_array_bitmap(b, a),
    (_B, _B): intersect_bitmap_bitmap,
    (_R, _R): intersect_run_run,
    (_R, _A): intersect_run_array,
    (_A, _R): lambda a, b: intersect_run_array(b, a),
    (_R, _B): intersect_run_bitmap,
    (_B, _R): lambda a, b: intersect_run_bitmap(b, a),
}

_OR_TABLE = {
    (_A, _A): union_array_array,
    (_A, _B): lambda a, b: union_array_bitmap(a, b),
    (_B, _A): lambda a, b: union_array_bitmap(b, a),
    (_B, _B): union_bitmap_bitmap,
    (_R, _R): union_run_run,
    (_R, _A): _or_words,
    (_A, _R): _or_words,
    (_R, _B): _or_words,
    (_B, _R): _or_words,
}

_ANDNOT_TABLE = {
    (_A, _A): andnot_array_any,
    (_A, _B): andnot_array_any,
    (_A, _R): andnot_array_any,
    (_B, _A): _andnot_words,
    (_B, _B): _andnot_words,
    (_B, _R): _andnot_words,
    (_R, _A): _andnot_words,
    (_R, _B): _andnot_words,
    (_R, _R): _andnot_words,
}


def container_or(a: Container, b: Container) -> Container:
    return _OR_TABLE[(type(a), type(b))](a, b)


def container_and(a: Container, b: Container) -> Container:
    return _AND_TABLE[(type(a), type(b))](a, b)


def container_xor(a: Container, b: Container) -> Container:
    """XOR (extension — the paper focuses on AND/OR; needed by the framework
    for mask algebra). Same dense/sparse materialization discipline."""
    return _xor_words(a, b)


def container_andnot(a: Container, b: Container) -> Container:
    """A AND NOT B (extension; used for e.g. KV-page reclamation)."""
    return _ANDNOT_TABLE[(type(a), type(b))](a, b)


# =============================================================================
# RoaringBitmap: the two-level index (paper S2-S4)
# =============================================================================

class RoaringBitmap:
    """Sorted first-level key array + containers, per the paper.

    Functional-style constructors (`from_array`) plus the mutating single-
    element `add`/`remove` used by the paper's Fig. 2e/2f benchmarks.
    """

    __slots__ = ("keys", "containers")

    def __init__(self, keys: Optional[List[int]] = None,
                 containers: Optional[List[Container]] = None):
        self.keys: List[int] = keys if keys is not None else []
        self.containers: List[Container] = containers if containers is not None else []

    # -- construction ---------------------------------------------------------
    @classmethod
    def from_array(cls, values: Iterable[int]) -> "RoaringBitmap":
        v = np.asarray(sorted(set(int(x) for x in values)), dtype=np.int64)
        return cls.from_sorted_unique(v)

    @classmethod
    def from_sorted_unique(cls, v: np.ndarray) -> "RoaringBitmap":
        """Bulk build: segment by high 16 bits, choose container type by the
        4096 rule."""
        rb = cls()
        if v.size == 0:
            return rb
        v = np.asarray(v, dtype=np.int64)
        lo = (v & (CHUNK_SIZE - 1)).astype(_U16)
        # each chunk's segment by a search of the sorted values (no pass
        # over every value to find the boundaries)
        keys = np.arange(int(v[0]) >> CHUNK_BITS,
                         (int(v[-1]) >> CHUNK_BITS) + 1, dtype=np.int64)
        starts = np.searchsorted(v, keys << CHUNK_BITS)
        ends = np.append(starts[1:], v.size)
        live = ends > starts
        for key, s, e in zip(keys[live].tolist(), starts[live].tolist(),
                             ends[live].tolist()):
            chunk = lo[s:e]
            if chunk.size > ARRAY_MAX:
                rb.keys.append(key)
                rb.containers.append(
                    BitmapContainer(array_to_bitmap(chunk), chunk.size))
            else:
                rb.keys.append(key)
                rb.containers.append(ArrayContainer(chunk.copy()))
        return rb

    @classmethod
    def from_ranges(cls, ranges: Sequence[Tuple[int, int]]) -> "RoaringBitmap":
        """Build run containers directly from half-open ``[start, end)``
        ranges — no per-element materialization (the run-shaped constructor
        the 2016 paper's workloads call for). Ranges may span chunks; they
        are split at 2^16 boundaries. Overlapping/adjacent ranges coalesce.
        Each container is best-of-three canonicalized."""
        spans = sorted((int(s), int(e)) for s, e in ranges if e > s)
        merged: List[List[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        per_key: dict = {}
        for s, e in merged:
            k = s >> CHUNK_BITS
            while s < e:
                chunk_end = min(e, (k + 1) << CHUNK_BITS)
                lo = s & (CHUNK_SIZE - 1)
                per_key.setdefault(k, ([], []))
                per_key[k][0].append(lo)
                per_key[k][1].append(chunk_end - s - 1)
                s = chunk_end
                k += 1
        rb = cls()
        for k in sorted(per_key):
            starts, lengths = per_key[k]
            rb.keys.append(k)
            rb.containers.append(_canonical(RunContainer(
                np.asarray(starts, np.int64), np.asarray(lengths, np.int64))))
        return rb

    @classmethod
    def from_range(cls, lo: int, hi: int) -> "RoaringBitmap":
        """Single contiguous ``[lo, hi)`` range (window/causal mask rows)."""
        return cls.from_ranges([(lo, hi)])

    def run_optimize(self) -> "RoaringBitmap":
        """The 2016 paper's ``runOptimize``: re-canonicalize every container
        best-of-three (array vs bitmap vs run by serialized size), in place."""
        self.containers = [_canonical(c) for c in self.containers]
        return self

    # -- access operations (paper S3) ------------------------------------------
    def _find_key(self, key: int) -> int:
        """Binary search the first-level index; returns position or -pos-1."""
        import bisect

        i = bisect.bisect_left(self.keys, key)
        if i < len(self.keys) and self.keys[i] == key:
            return i
        return -i - 1

    def contains(self, x: int) -> bool:
        i = self._find_key(x >> CHUNK_BITS)
        if i < 0:
            return False
        return self.containers[i].contains(x & (CHUNK_SIZE - 1))

    __contains__ = contains

    def add(self, x: int) -> None:
        key, low = x >> CHUNK_BITS, x & (CHUNK_SIZE - 1)
        i = self._find_key(key)
        if i >= 0:
            self.containers[i] = self.containers[i].add(low)
        else:
            pos = -i - 1
            self.keys.insert(pos, key)
            self.containers.insert(pos, ArrayContainer(np.asarray([low], dtype=_U16)))

    def remove(self, x: int) -> None:
        key, low = x >> CHUNK_BITS, x & (CHUNK_SIZE - 1)
        i = self._find_key(key)
        if i < 0:
            return
        c = self.containers[i].remove(low)
        if c.cardinality == 0:
            del self.keys[i]
            del self.containers[i]
        else:
            self.containers[i] = c

    # -- aggregate queries (paper S2) -------------------------------------------
    @property
    def cardinality(self) -> int:
        """Sum of at most ceil(n / 2^16) per-container counters."""
        return sum(c.cardinality for c in self.containers)

    def __len__(self) -> int:
        return self.cardinality

    def rank(self, x: int) -> int:
        """# of set entries <= x: whole-container counters + one partial."""
        key, low = x >> CHUNK_BITS, x & (CHUNK_SIZE - 1)
        total = 0
        for k, c in zip(self.keys, self.containers):
            if k < key:
                total += c.cardinality
            elif k == key:
                if isinstance(c, ArrayContainer):
                    total += int(np.searchsorted(c.arr, _U16(low), side="right"))
                elif isinstance(c, RunContainer):
                    total += c.rank(low)
                else:
                    full_words = low >> 6
                    total += popcount_words(c.words[:full_words])
                    rem = (low & 63) + 1
                    total += int(int(c.words[full_words]) & ((1 << rem) - 1)).bit_count()
            else:
                break
        return total

    def select(self, j: int) -> int:
        """Value of the j-th (0-based) smallest element."""
        if j < 0 or j >= self.cardinality:
            raise IndexError(j)
        for k, c in zip(self.keys, self.containers):
            if j < c.cardinality:
                if isinstance(c, ArrayContainer):
                    return (k << CHUNK_BITS) | int(c.arr[j])
                if isinstance(c, RunContainer):
                    # run-length prefix sums, O(log n_runs) — the KV
                    # allocator's free.select(0) pops from a run pool
                    cum = np.cumsum(c.lengths + 1)
                    r = int(np.searchsorted(cum, j, side="right"))
                    prev = int(cum[r - 1]) if r else 0
                    return (k << CHUNK_BITS) | int(c.starts[r] + j - prev)
                return (k << CHUNK_BITS) | int(c.to_array()[j])
            j -= c.cardinality
        raise AssertionError("unreachable")

    # -- binary logical operations (paper S4 first-level merge) -----------------
    #
    # The paper merges the two sorted first-level arrays in O(n1 + n2) integer
    # comparisons; in numpy the same merge is done with vectorized sorted-set
    # routines so that per-container *python* overhead is only paid for keys
    # that actually produce work (all keys for OR, matching keys for AND).
    def _binary_op(self, other: "RoaringBitmap", op, union_keys: bool) -> "RoaringBitmap":
        out = RoaringBitmap()
        ka = np.asarray(self.keys, dtype=np.int64)
        kb = np.asarray(other.keys, dtype=np.int64)
        if not union_keys:
            common, ia, ib = np.intersect1d(ka, kb, assume_unique=True,
                                            return_indices=True)
            for k, i, j in zip(common.tolist(), ia.tolist(), ib.tolist()):
                c = op(self.containers[i], other.containers[j])
                if c.cardinality > 0:
                    out.keys.append(k)
                    out.containers.append(_canonical(c))
            return out
        union = np.union1d(ka, kb)
        pa = np.searchsorted(ka, union)
        pb = np.searchsorted(kb, union)
        in_a = (pa < ka.size) & (ka[np.minimum(pa, max(ka.size - 1, 0))] == union) \
            if ka.size else np.zeros(union.size, dtype=bool)
        in_b = (pb < kb.size) & (kb[np.minimum(pb, max(kb.size - 1, 0))] == union) \
            if kb.size else np.zeros(union.size, dtype=bool)
        for k, i, j, a_has, b_has in zip(union.tolist(), pa.tolist(), pb.tolist(),
                                         in_a.tolist(), in_b.tolist()):
            if a_has and b_has:
                c = op(self.containers[i], other.containers[j])
            elif a_has:
                c = self.containers[i].clone()
            else:
                c = other.containers[j].clone()
            if c.cardinality > 0:
                out.keys.append(k)
                out.containers.append(_canonical(c))
        return out

    def __and__(self, other: "RoaringBitmap") -> "RoaringBitmap":
        return self._binary_op(other, container_and, union_keys=False)

    def __or__(self, other: "RoaringBitmap") -> "RoaringBitmap":
        return self._binary_op(other, container_or, union_keys=True)

    def __xor__(self, other: "RoaringBitmap") -> "RoaringBitmap":
        return self._binary_op(other, container_xor, union_keys=True)

    def andnot(self, other: "RoaringBitmap") -> "RoaringBitmap":
        out = RoaringBitmap()
        j = 0
        for k, c in zip(self.keys, self.containers):
            i = other._find_key(k)
            if i < 0:
                out.keys.append(k)
                out.containers.append(_canonical(c.clone()))
            else:
                r = container_andnot(c, other.containers[i])
                if r.cardinality > 0:
                    out.keys.append(k)
                    out.containers.append(_canonical(r))
        return out

    # -- in-place union (S4 in-place variants) ----------------------------------
    def ior(self, other: "RoaringBitmap") -> "RoaringBitmap":
        """Self |= other, modifying bitmap containers in place when possible."""
        i = j = 0
        n2 = len(other.keys)
        while j < n2:
            k2 = other.keys[j]
            if i >= len(self.keys) or self.keys[i] > k2:
                self.keys.insert(i, k2)
                self.containers.insert(
                    i, _canonical(other.containers[j].clone()))
                i += 1
                j += 1
            elif self.keys[i] < k2:
                i += 1
            else:
                a, b = self.containers[i], other.containers[j]
                if isinstance(a, BitmapContainer) and isinstance(b, BitmapContainer):
                    self.containers[i] = _canonical(
                        union_bitmap_bitmap_inplace(a, b))
                else:
                    self.containers[i] = _canonical(container_or(a, b))
                i += 1
                j += 1
        return self

    # -- export -----------------------------------------------------------------
    def to_array(self) -> np.ndarray:
        parts = []
        for k, c in zip(self.keys, self.containers):
            parts.append((k << CHUNK_BITS) + c.to_array().astype(np.int64))
        if not parts:
            return np.empty(0, dtype=np.int64)
        return np.concatenate(parts)

    def iter_values(self) -> Iterator[int]:
        for k, c in zip(self.keys, self.containers):
            base = k << CHUNK_BITS
            for v in c.iter_values():
                yield base + v

    # -- size accounting (bits/item experiments) ---------------------------------
    def size_in_bytes(self) -> int:
        """Serialized size: 4 bytes/container header (16-bit key + 16-bit
        cardinality) + container payloads + 8-byte index header."""
        total = 8 + 4 * len(self.containers)
        for c in self.containers:
            total += c.size_in_bytes()
        return total

    def container_stats(self) -> Tuple[int, int]:
        n_arr = sum(1 for c in self.containers if isinstance(c, ArrayContainer))
        return n_arr, len(self.containers) - n_arr

    def kind_stats(self) -> Tuple[int, int, int]:
        """(n_array, n_bitmap, n_run) container counts."""
        na = sum(1 for c in self.containers if isinstance(c, ArrayContainer))
        nb = sum(1 for c in self.containers if isinstance(c, BitmapContainer))
        return na, nb, len(self.containers) - na - nb

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, RoaringBitmap):
            return NotImplemented
        return np.array_equal(self.to_array(), other.to_array())

    def __repr__(self) -> str:
        na, nb, nr = self.kind_stats()
        return (f"RoaringBitmap(card={self.cardinality}, containers={na} array"
                f" + {nb} bitmap + {nr} run)")


# =============================================================================
# Algorithm 4: optimized many-way union
# =============================================================================

def union_many(bitmaps: Sequence[RoaringBitmap]) -> RoaringBitmap:
    """Paper Algorithm 4: min-heap of (key, container); for each key group,
    clone the max-cardinality container, OR the rest in place *without*
    cardinality maintenance, and recount once at the end."""
    heap: List[Tuple[int, int, int]] = []  # (key, bitmap_idx, container_idx)
    for bi, rb in enumerate(bitmaps):
        for ci, k in enumerate(rb.keys):
            heapq.heappush(heap, (k, bi, ci))
    out = RoaringBitmap()
    while heap:
        key = heap[0][0]
        group: List[Container] = []
        while heap and heap[0][0] == key:
            _, bi, ci = heapq.heappop(heap)
            group.append(bitmaps[bi].containers[ci])
        group.sort(key=lambda c: -c.cardinality)
        a = group[0].clone()
        if len(group) == 1:
            out.keys.append(key)
            out.containers.append(_canonical(a))
            continue
        if not isinstance(a, BitmapContainer):
            # array/run mode: Alg. 4 line 13 — pair-merge (run-merge for run
            # operands) until the accumulator upgrades to bitmap
            for qi, q in enumerate(group[1:]):
                a = container_or(a, q)
                if isinstance(a, BitmapContainer):
                    break
        if isinstance(a, BitmapContainer):
            # bitmap mode: in-place ORs with deferred cardinality (lines 10-11);
            # re-ORing containers already merged during array mode is a no-op
            # (idempotent), so we simply sweep the whole group.
            for q in group[1:]:
                np.bitwise_or(a.words, _words_of(q), out=a.words)
            a.cardinality = popcount_words(a.words)  # line 14: once at the end
        out.keys.append(key)
        out.containers.append(_canonical(a))
    return out
