"""Portable Roaring serialization (``RoaringFormatSpec``) — hardened codec.

The interchange format of the Roaring ecosystem (the layout CRoaring,
RoaringBitmap/Java, and pyroaring all read and write — see the 2017
implementation paper, S4 "Serialization"):

* little-endian ``u32`` cookie — ``12347`` (``SERIAL_COOKIE``, low 16 bits)
  when any run container is present, with ``n_containers - 1`` packed in the
  high 16 bits; plain ``12346`` (``SERIAL_COOKIE_NO_RUNCONTAINER``) followed
  by a ``u32`` container count otherwise;
* with runs: a bitset of ``ceil(n/8)`` bytes flagging which containers are
  run-encoded;
* the *descriptive header*: one ``(key u16, cardinality-1 u16)`` pair per
  container, in ascending key order;
* the *offset header* — one ``u32`` byte offset (from the start of the
  stream) per container — present when there are no runs, or when
  ``n_containers >= NO_OFFSET_THRESHOLD`` (4);
* container payloads in key order: arrays as ``card`` sorted ``u16`` values,
  bitmaps as 1024 little-endian ``u64`` words (8 kB), runs as a ``u16`` run
  count followed by ``(start u16, length-1 u16)`` pairs.

Kind round-trips exactly for every container the format can represent: a
non-run container is a bitmap iff ``cardinality > 4096``, which is precisely
the slab/oracle canonical rule (array takes the 4096 tie), so canonical
bitmaps — every set-algebra output — serialize and deserialize to identical
kinds, payloads, and bytes. The codec is host-side (bytes are not a device
type); the device entry points are ``RoaringSlab.serialize`` /
``RoaringSlab.deserialize``. This is the port's own copy of the reference
package's codec: the two must produce the same bytes.

Threat model: ``deserialize`` treats its input as *untrusted* (a cookie from
a hostile client, a corrupted object-store blob). Every read is
bounds-checked before it happens, the offset header is verified against the
actual payload positions, keys must be sorted-unique, run pairs must be
sorted / non-overlapping / in-range, bitmap popcounts and array lengths must
match the declared cardinalities, and a ``DecodeLimits`` guard caps the
container count and stream size so a lying header cannot drive a large
allocation. Any violation raises a ``RoaringFormatError`` subclass carrying
the byte offset of the offending read — never a bare numpy/struct error, and
never a silently-wrong bitmap. An accepted stream re-serializes
byte-for-byte (the layout is fully determined by the parsed structure), so
``serialize(deserialize(data)) == data`` for every stream ``deserialize``
accepts.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional

import numpy as np

from repro_torch.core import py_roaring as pr

__all__ = [
    "RoaringFormatSpec", "DecodeLimits",
    "RoaringFormatError", "TruncatedStreamError", "CookieError",
    "DescriptiveHeaderError", "OffsetHeaderError", "PayloadError",
    "TrailingDataError", "DecodeLimitError",
]

# hard structural ceilings of the format itself (u16 keys -> at most 2^16
# containers; a run payload row holds at most 2048 (start, len-1) pairs in
# the device slab layout)
_MAX_CONTAINERS = 1 << 16
_MAX_RUNS = 2048


class RoaringFormatError(ValueError):
    """A portable-format stream violated the format contract.

    Carries the byte ``offset`` of the offending read and, when the failure
    is container-scoped, the ``container`` index — so callers (and fuzz
    triage) can point at the exact corrupt byte. Subclasses name the stream
    region that failed; all of them are ``ValueError``s, so pre-hardening
    callers that caught ``ValueError`` still work.
    """

    def __init__(self, msg: str, *, offset: Optional[int] = None,
                 container: Optional[int] = None):
        self.offset = offset
        self.container = container
        ctx = []
        if container is not None:
            ctx.append(f"container {container}")
        if offset is not None:
            ctx.append(f"byte offset {offset}")
        super().__init__(msg + (f" [{', '.join(ctx)}]" if ctx else ""))


class TruncatedStreamError(RoaringFormatError):
    """The stream ends before a required read (cookie, header, payload)."""


class CookieError(RoaringFormatError):
    """The leading u32 is not a Roaring cookie, or lies about the stream
    (e.g. a run cookie whose run bitset flags no container)."""


class DescriptiveHeaderError(RoaringFormatError):
    """Keys out of order / duplicated in the descriptive header."""


class OffsetHeaderError(RoaringFormatError):
    """An offset-header entry disagrees with the actual payload position."""


class PayloadError(RoaringFormatError):
    """A container payload contradicts its header: bad run pairs, unsorted
    array values, or a bitmap popcount that differs from the declared
    cardinality."""


class TrailingDataError(RoaringFormatError):
    """Bytes remain after the last container payload."""


class DecodeLimitError(RoaringFormatError):
    """The stream exceeds the caller's ``DecodeLimits`` resource guard."""


@dataclasses.dataclass(frozen=True)
class DecodeLimits:
    """Resource guard for decoding untrusted streams.

    ``max_containers`` caps the container count *before* any per-container
    work happens (the format ceiling is 2^16; servers decoding hostile
    cookies should set this to their real schema bound), and
    ``max_stream_bytes`` rejects oversized blobs up front. Bounds checking
    already guarantees allocations never exceed the actual stream length —
    the limits exist so a hostile 256 MB cookie is refused in O(1) instead
    of parsed in O(n).
    """

    max_containers: int = _MAX_CONTAINERS
    max_stream_bytes: int = 1 << 28           # 256 MiB

    def __post_init__(self):
        if self.max_containers < 1 or self.max_stream_bytes < 8:
            raise ValueError("DecodeLimits must allow at least one "
                             "container and an 8-byte stream")


_DEFAULT_LIMITS = DecodeLimits()


def _raise_unless_sorted(arr: np.ndarray, i: int, payload_pos: int) -> None:
    """Exact-offset strictly-increasing check for one array payload."""
    if (arr[1:] > arr[:-1]).all():
        return
    bad = np.nonzero(arr[1:] <= arr[:-1])[0]
    j = int(bad[0])
    raise PayloadError(
        f"array values not sorted-unique: value[{j + 1}] = "
        f"{int(arr[j + 1])} after value[{j}] = {int(arr[j])}",
        offset=payload_pos + 2 * (j + 1), container=i)


class RoaringFormatSpec:
    """Codec constants + (de)serialization of host ``RoaringBitmap``s."""

    SERIAL_COOKIE: int = 12347
    SERIAL_COOKIE_NO_RUNCONTAINER: int = 12346
    NO_OFFSET_THRESHOLD: int = 4

    @classmethod
    def serialize(cls, rb: pr.RoaringBitmap) -> bytes:
        """``RoaringBitmap`` -> portable byte stream (format above)."""
        n = len(rb.keys)
        if n > _MAX_CONTAINERS:
            raise ValueError(f"{n} containers exceed the format's 2^16 "
                             "container ceiling")
        has_run = any(isinstance(c, pr.RunContainer) for c in rb.containers)
        buf = bytearray()
        if has_run:
            buf += struct.pack("<I", cls.SERIAL_COOKIE | ((n - 1) << 16))
            bitset = bytearray((n + 7) // 8)
            for i, c in enumerate(rb.containers):
                if isinstance(c, pr.RunContainer):
                    bitset[i >> 3] |= 1 << (i & 7)
            buf += bitset
        else:
            buf += struct.pack("<II", cls.SERIAL_COOKIE_NO_RUNCONTAINER, n)
        for k, c in zip(rb.keys, rb.containers):
            if not 0 <= k < (1 << 16):
                raise ValueError(f"container key {k} outside the 32-bit "
                                 "universe the portable format addresses")
            if c.cardinality == 0:
                raise ValueError(f"empty container at key {k} (the format "
                                 "has no empty-container encoding)")
            buf += struct.pack("<HH", k, c.cardinality - 1)
        with_offsets = (not has_run) or n >= cls.NO_OFFSET_THRESHOLD
        off_pos = len(buf)
        if with_offsets:
            buf += b"\x00" * (4 * n)
        offsets: List[int] = []
        for c in rb.containers:
            offsets.append(len(buf))
            if isinstance(c, pr.RunContainer):
                buf += struct.pack("<H", c.n_runs)
                pairs = np.empty(2 * c.n_runs, dtype="<u2")
                pairs[0::2] = c.starts
                pairs[1::2] = c.lengths          # stored as length-1 already
                buf += pairs.tobytes()
            elif isinstance(c, pr.BitmapContainer):
                buf += np.ascontiguousarray(c.words, dtype="<u8").tobytes()
            else:
                buf += np.ascontiguousarray(c.arr, dtype="<u2").tobytes()
        if with_offsets:
            buf[off_pos:off_pos + 4 * n] = struct.pack(f"<{n}I", *offsets)
        return bytes(buf)

    # -- hardened decode ------------------------------------------------------
    @classmethod
    def deserialize(cls, data: bytes, *,
                    limits: Optional[DecodeLimits] = None,
                    check: bool = False) -> pr.RoaringBitmap:
        """Untrusted portable byte stream -> ``RoaringBitmap``.

        Structural validation always runs (bounds, offsets, key order, run
        pairs, cardinality-vs-payload agreement); ``check=True`` additionally
        runs the full invariant auditor (``repro_torch.roaring.validate``)
        on the result and raises ``InvariantViolation`` (a
        ``RoaringFormatError``) if it reports anything. ``limits`` defaults
        to ``DecodeLimits()``.
        """
        lim = limits if limits is not None else _DEFAULT_LIMITS
        ln = len(data)
        if ln > lim.max_stream_bytes:
            raise DecodeLimitError(
                f"stream of {ln} bytes exceeds max_stream_bytes "
                f"{lim.max_stream_bytes}", offset=0)

        def need(pos: int, k: int, what: str,
                 container: Optional[int] = None) -> None:
            if pos + k > ln:
                raise TruncatedStreamError(
                    f"truncated stream: {what} needs {k} bytes, "
                    f"{ln - pos} remain", offset=pos, container=container)

        need(0, 4, "cookie")
        (cookie,) = struct.unpack_from("<I", data, 0)
        pos = 4
        if cookie & 0xFFFF == cls.SERIAL_COOKIE:
            n = (cookie >> 16) + 1
            if n > lim.max_containers:
                raise DecodeLimitError(
                    f"cookie declares {n} containers, limit is "
                    f"{lim.max_containers}", offset=0)
            nbytes = (n + 7) // 8
            need(pos, nbytes, "run-flag bitset")
            runbits = data[pos:pos + nbytes]
            pos += nbytes
            is_run = [(runbits[i >> 3] >> (i & 7)) & 1 == 1 for i in range(n)]
            if not any(is_run):
                raise CookieError(
                    "run cookie (12347) but the run bitset flags no "
                    "container (the no-run encoding is cookie 12346)",
                    offset=4)
            with_offsets = n >= cls.NO_OFFSET_THRESHOLD
        elif cookie == cls.SERIAL_COOKIE_NO_RUNCONTAINER:
            need(pos, 4, "container count")
            (n,) = struct.unpack_from("<I", data, pos)
            pos += 4
            if n > _MAX_CONTAINERS:
                raise CookieError(
                    f"container count {n} exceeds the format's 2^16 "
                    "container ceiling", offset=4)
            if n > lim.max_containers:
                raise DecodeLimitError(
                    f"stream declares {n} containers, limit is "
                    f"{lim.max_containers}", offset=4)
            is_run = [False] * n
            with_offsets = True
        else:
            raise CookieError(
                f"not a portable roaring stream (cookie {cookie & 0xFFFF})",
                offset=0)

        desc_pos = pos
        need(pos, 4 * n, "descriptive header")
        # plain Python ints throughout the loop: per-container numpy scalar
        # extraction is the decode loop's biggest fixed cost. Below ~64
        # containers a single bulk struct.unpack_from beats the numpy
        # frombuffer/astype/tolist chain outright; above it, numpy wins.
        if n < 64:
            flat_desc = struct.unpack_from(f"<{2 * n}H", data, pos)
            key_list = flat_desc[0::2]
            card_list = [c + 1 for c in flat_desc[1::2]]
            pos += 4 * n
            for i in range(1, n):
                if key_list[i] <= key_list[i - 1]:
                    raise DescriptiveHeaderError(
                        f"keys not sorted-unique: key[{i}] = "
                        f"{key_list[i]} after key[{i - 1}] = "
                        f"{key_list[i - 1]}",
                        offset=desc_pos + 4 * i, container=i)
        else:
            desc = np.frombuffer(data, dtype="<u2", count=2 * n, offset=pos)
            keys = desc[0::2].astype(np.int64)
            pos += 4 * n
            if not (keys[1:] > keys[:-1]).all():
                bad = np.nonzero(keys[1:] <= keys[:-1])[0]
                i = int(bad[0])
                raise DescriptiveHeaderError(
                    f"keys not sorted-unique: key[{i + 1}] = "
                    f"{int(keys[i + 1])} after key[{i}] = {int(keys[i])}",
                    offset=desc_pos + 4 * (i + 1), container=i + 1)
            key_list = keys.tolist()
            card_list = (desc[1::2].astype(np.int64) + 1).tolist()

        off_pos = pos
        off_list: Optional[tuple] = None
        if with_offsets:
            need(pos, 4 * n, "offset header")
            off_list = (struct.unpack_from(f"<{n}I", data, pos) if n < 64
                        else tuple(np.frombuffer(data, dtype="<u4", count=n,
                                                 offset=pos).tolist()))
            pos += 4 * n

        rb = pr.RoaringBitmap()
        # bitmap popcount and array sortedness verification are deferred
        # and batched: ONE ufunc launch over every payload of the class
        # beats per-container launches ~4x at typical container counts
        # (tiny-array numpy calls are dominated by launch overhead)
        bitmap_checks: list = []             # (container, payload_pos)
        bitmap_words: list = []
        array_checks: list = []              # (container, payload_pos, arr)
        for i in range(n):
            if off_list is not None and off_list[i] != pos:
                raise OffsetHeaderError(
                    f"offset header says payload at {off_list[i]}, "
                    f"actual position is {pos}", offset=off_pos + 4 * i,
                    container=i)
            card_i = card_list[i]
            if is_run[i]:
                if pos + 2 > ln:
                    need(pos, 2, "run count", container=i)
                (n_runs,) = struct.unpack_from("<H", data, pos)
                run_pos = pos
                pos += 2
                if n_runs == 0:
                    raise PayloadError(
                        "run container with zero runs (cardinality is "
                        "at least 1)", offset=run_pos, container=i)
                if n_runs > _MAX_RUNS:
                    raise PayloadError(
                        f"{n_runs} runs exceed the 2048-run container "
                        "ceiling", offset=run_pos, container=i)
                if pos + 4 * n_runs > ln:
                    need(pos, 4 * n_runs, "run pairs", container=i)
                c: Optional[pr.Container] = None
                if n_runs >= 32:
                    # vectorized fast pass for long run lists; on any
                    # violation fall through to the Python walk, which
                    # pins the exact offending pair and byte offset
                    pv = np.frombuffer(data, dtype="<u2", count=2 * n_runs,
                                       offset=pos).astype(np.int64)
                    s_arr, l_arr = pv[0::2], pv[1::2]
                    e_arr = s_arr + l_arr                # inclusive ends
                    if ((e_arr <= 0xFFFF).all()
                            and (s_arr[1:] > e_arr[:-1]).all()
                            and int(l_arr.sum()) + n_runs == card_i):
                        c = pr.RunContainer(s_arr, l_arr)
                if c is None:
                    # pure-Python pair walk: for the short run lists real
                    # data produces, this beats five+ numpy ops on tiny
                    # arrays — and it is the exact-offset error path
                    flat = struct.unpack_from(f"<{2 * n_runs}H", data, pos)
                    prev_end, total = -1, 0
                    for j in range(n_runs):
                        s, l = flat[2 * j], flat[2 * j + 1]
                        e = s + l                        # inclusive end
                        if e > 0xFFFF:
                            raise PayloadError(
                                f"run {j} = (start {s}, len {l + 1}) "
                                "exceeds the 16-bit chunk (start + length "
                                "- 1 > 65535)",
                                offset=pos + 4 * j, container=i)
                        if s <= prev_end:
                            raise PayloadError(
                                f"runs {j - 1} and {j} out of order or "
                                f"overlapping: run {j - 1} ends at "
                                f"{prev_end}, run {j} starts at {s}",
                                offset=pos + 4 * j, container=i)
                        prev_end = e
                        total += l + 1
                    if total != card_i:
                        raise PayloadError(
                            f"header cardinality {card_i} != run payload "
                            f"cardinality {total}",
                            offset=desc_pos + 4 * i + 2, container=i)
                    c = pr.RunContainer(
                        np.asarray(flat[0::2], np.int64),
                        np.asarray(flat[1::2], np.int64))
                pos += 4 * n_runs
            elif card_i > pr.ARRAY_MAX:
                if pos + 8192 > ln:
                    need(pos, 8192, "bitmap payload", container=i)
                words = np.frombuffer(data, dtype="<u8", count=1024,
                                      offset=pos).astype(np.uint64)
                bitmap_checks.append((i, pos))
                bitmap_words.append(words)
                pos += 8192
                c = pr.BitmapContainer(words, cardinality=card_i)
            else:
                if pos + 2 * card_i > ln:
                    need(pos, 2 * card_i, "array payload", container=i)
                arr = np.frombuffer(data, dtype="<u2", count=card_i,
                                    offset=pos).astype(np.uint16)
                if card_i > 1:
                    array_checks.append((i, pos, arr))
                pos += 2 * card_i
                c = pr.ArrayContainer(arr)
            # card-vs-payload agreement is proven per branch: runs sum
            # their lengths, bitmaps popcount and arrays sorted-unique in
            # the batched epilogue below, arrays read exactly card_i values
            rb.keys.append(key_list[i])
            rb.containers.append(c)
        if pos != ln:
            raise TrailingDataError(
                f"{ln - pos} trailing bytes after the last container "
                "payload", offset=pos)
        cls._check_arrays_sorted(array_checks)
        if bitmap_checks:
            counts = np.bitwise_count(
                np.concatenate(bitmap_words)).reshape(
                    len(bitmap_words), 1024).sum(axis=1).tolist()
            for (i, payload_pos), got in zip(bitmap_checks, counts):
                if got != card_list[i]:
                    raise PayloadError(
                        f"bitmap popcount {got} != declared cardinality "
                        f"{card_list[i]}", offset=payload_pos, container=i)
        if check:
            from repro_torch.roaring import validate as _v
            _v.audit_bitmap(rb).raise_on_violation()
        return rb

    @staticmethod
    def _check_arrays_sorted(array_checks: list) -> None:
        """Batched strictly-increasing check over every array payload.

        One pass over all payloads concatenated, entirely in uint16 (no
        widening): with wraparound steps ``e_j = (a[j+1] - a[j] - 1) mod
        2^16``, a segment of length m is strictly increasing iff
        ``sum(e) == last - first - (m - 1)`` — every non-increasing step
        adds exactly 2^16 to the sum, so the identity is exact, not a
        heuristic. Cross-segment boundary steps are zeroed and per-segment
        sums come from one ``np.add.reduceat``. On failure, the offending
        container is re-checked alone for an exact byte offset (error
        path, cost irrelevant).
        """
        if not array_checks:
            return
        if len(array_checks) <= 12:
            # few arrays: two small ufunc launches each beat the batched
            # pass's fixed cost (concat/reduceat/gather launches)
            for i, payload_pos, arr in array_checks:
                _raise_unless_sorted(arr, i, payload_pos)
            return
        lens = [a.shape[0] for (_, _, a) in array_checks]
        ends = np.cumsum(lens)
        combined = np.concatenate([a for (_, _, a) in array_checks])
        e = combined[1:] - combined[:-1]     # u16 wraparound, intentional
        e -= 1                               # equal step wraps to 65535
        e[ends[:-1] - 1] = 0                 # neutralize boundary steps
        starts = ends - np.asarray(lens)
        sums = np.add.reduceat(e, starts, dtype=np.int64)
        firsts = combined[starts].astype(np.int64)
        lasts = combined[ends - 1].astype(np.int64)
        expect = lasts - firsts - (np.asarray(lens, dtype=np.int64) - 1)
        if (sums == expect).all():
            return
        for i, payload_pos, arr in array_checks:       # locate (error path)
            _raise_unless_sorted(arr, i, payload_pos)

    # -- trusted-path baseline (A/B benchmark only) ---------------------------
    @classmethod
    def _deserialize_trusted(cls, data: bytes) -> pr.RoaringBitmap:
        """The pre-hardening decode loop, kept as the trusted-input
        baseline that validation overhead is measured against (the
        reference's ``robust/*`` benchmark rows gate it at <= 1.3x this
        path). Never feed it untrusted bytes."""
        (cookie,) = struct.unpack_from("<I", data, 0)
        pos = 4
        if cookie & 0xFFFF == cls.SERIAL_COOKIE:
            n = (cookie >> 16) + 1
            nbytes = (n + 7) // 8
            runbits = data[pos:pos + nbytes]
            pos += nbytes
            is_run = [(runbits[i >> 3] >> (i & 7)) & 1 == 1 for i in range(n)]
            with_offsets = n >= cls.NO_OFFSET_THRESHOLD
        else:
            (n,) = struct.unpack_from("<I", data, pos)
            pos += 4
            is_run = [False] * n
            with_offsets = True
        keys, cards = [], []
        for _ in range(n):
            k, cm1 = struct.unpack_from("<HH", data, pos)
            pos += 4
            keys.append(k)
            cards.append(cm1 + 1)
        if with_offsets:
            pos += 4 * n
        rb = pr.RoaringBitmap()
        for i in range(n):
            if is_run[i]:
                (n_runs,) = struct.unpack_from("<H", data, pos)
                pos += 2
                pairs = np.frombuffer(data, dtype="<u2", count=2 * n_runs,
                                      offset=pos).astype(np.int64)
                pos += 4 * n_runs
                c: pr.Container = pr.RunContainer(pairs[0::2], pairs[1::2])
            elif cards[i] > pr.ARRAY_MAX:
                words = np.frombuffer(data, dtype="<u8", count=1024,
                                      offset=pos).astype(np.uint64)
                pos += 8192
                c = pr.BitmapContainer(words, cardinality=cards[i])
            else:
                arr = np.frombuffer(data, dtype="<u2", count=cards[i],
                                    offset=pos).astype(np.uint16)
                pos += 2 * cards[i]
                c = pr.ArrayContainer(arr)
            rb.keys.append(keys[i])
            rb.containers.append(c)
        return rb
