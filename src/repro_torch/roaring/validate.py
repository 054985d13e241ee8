"""Structural invariant auditor for the Roaring data plane (the port's own
copy of the reference package's auditor: the same checks, codes and
messages).

The paper's data structure is cheap to *verify*, not just to assume: every
container carries its kind, cardinality, and (for runs) run count, so a
linear host-side pass can confirm the whole two-level index is well formed —
sorted-unique keys, per-container cardinality agreeing with the payload
(array length / bitmap popcount / run-length sum), run pairs sorted,
non-overlapping and in-range, and (optionally) the strict best-of-three
canonical-kind rule that makes slab and oracle bit-identical.

Three subjects, one report shape:

* ``audit_bitmap`` — host ``py_roaring.RoaringBitmap``;
* ``audit_slab`` — device ``repro_torch.roaring.RoaringSlab`` (single or
  stacked: a stacked slab audits every member; violations carry the member
  index);
* ``audit_page_table`` — the serving-side ``RoaringPageTable``: the free
  pool and the per-sequence page sets must exactly partition ``[0,
  n_pages)`` (no leaked pages, no double allocation), and the incremental
  free bitmap must itself audit clean.

Reports are machine-readable: an ``AuditReport`` holds per-container
``Violation`` records (code, container index, key, human detail). Nothing
here raises on bad data by itself — call ``raise_on_violation()`` (used by
``deserialize(check=True)`` / ``from_roaring(check=True)``) to escalate a
dirty report to ``InvariantViolation``, which subclasses
``RoaringFormatError`` so untrusted-input callers keep a single except arm.

``canonical=True`` additionally enforces the strict best-of-three kind rule
(run iff ``4*n_runs < min(2*card, 8192)``; array takes the 4096 tie) — true
for every set-algebra output, but deliberately *not* part of the structural
contract: bulk constructors (``from_sorted_unique``) are 2-kind by design
and foreign streams may legally ship non-canonical kinds.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.core import py_roaring as pr
from repro_torch.roaring.format import RoaringFormatError

__all__ = [
    "Violation", "AuditReport", "InvariantViolation",
    "audit_bitmap", "audit_slab", "audit_page_table",
]


class InvariantViolation(RoaringFormatError):
    """A structural audit failed (raised by ``AuditReport.raise_on_violation``
    and the ``check=True`` decode/bridge paths)."""


@dataclasses.dataclass(frozen=True)
class Violation:
    """One invariant breach, anchored to a container.

    ``code`` is a stable machine-readable slug (``key-order``,
    ``card-mismatch``, ``run-pairs``, ``kind-range``, ``canonical-kind``,
    ``page-leak``, ...); ``container`` is the container/row index within its
    bitmap (or ``-1`` for structure-level breaches), ``member`` the stacked-
    slab member (or ``-1``), ``key`` the 16-bit chunk key (or ``-1``)."""

    code: str
    container: int
    key: int
    detail: str
    member: int = -1


@dataclasses.dataclass(frozen=True)
class AuditReport:
    """Machine-readable audit result for one subject."""

    subject: str
    n_containers: int
    violations: Tuple[Violation, ...]

    @property
    def ok(self) -> bool:
        return not self.violations

    def raise_on_violation(self) -> "AuditReport":
        """Escalate a dirty report to ``InvariantViolation``; returns self
        when clean so it chains off decode paths."""
        if self.violations:
            head = "; ".join(
                f"{v.code}@{v.container}: {v.detail}"
                for v in self.violations[:4])
            more = len(self.violations) - 4
            raise InvariantViolation(
                f"{self.subject}: {len(self.violations)} invariant "
                f"violation(s): {head}" + (f"; +{more} more" if more > 0
                                           else ""))
        return self

    def summary(self) -> str:
        return (f"{self.subject}: {self.n_containers} containers audited, "
                + ("clean" if self.ok
                   else f"{len(self.violations)} violation(s)"))


def _minimal_nruns_of_array(vals: np.ndarray) -> int:
    if vals.size == 0:
        return 0
    return int(np.count_nonzero(np.diff(vals.astype(np.int64)) != 1)) + 1


def _check_canonical_kind(out: List[Violation], kind_name: str, card: int,
                          min_nruns: int, i: int, key: int,
                          member: int = -1) -> None:
    """The strict best-of-three rule, mirroring ``jax_roaring._pick_kind``
    and ``py_roaring._canonical``: run wins iff 4*n_runs is strictly smaller
    than every alternative; array takes the 4096 tie against bitmap."""
    size_other = min(2 * card, 2 * pr.ARRAY_MAX) if card <= pr.ARRAY_MAX \
        else 2 * pr.ARRAY_MAX
    want = "run" if (card > 0 and 4 * min_nruns < size_other) else (
        "array" if card <= pr.ARRAY_MAX else "bitmap")
    if kind_name != want:
        out.append(Violation(
            "canonical-kind", i, key,
            f"kind {kind_name} but best-of-three picks {want} "
            f"(card {card}, minimal runs {min_nruns})", member))


def _audit_array(out: List[Violation], vals: np.ndarray, card: int, i: int,
                 key: int, member: int = -1) -> None:
    v = vals.astype(np.int64)
    if v.size != card:
        out.append(Violation(
            "card-mismatch", i, key,
            f"array payload holds {v.size} values, counter says {card}",
            member))
    if v.size and (int(v[0]) < 0 or int(v[-1]) > 0xFFFF):
        out.append(Violation(
            "value-range", i, key,
            f"array values outside [0, 65536): [{int(v[0])}, {int(v[-1])}]",
            member))
    if v.size > pr.ARRAY_MAX:
        out.append(Violation(
            "card-range", i, key,
            f"array container with {v.size} values exceeds the 4096 "
            "threshold", member))
    if v.size > 1 and not bool(np.all(np.diff(v) > 0)):
        out.append(Violation(
            "array-order", i, key, "array values not strictly increasing",
            member))


def _audit_runs(out: List[Violation], starts: np.ndarray, lengths: np.ndarray,
                card: int, i: int, key: int, member: int = -1) -> None:
    s = starts.astype(np.int64)
    l = lengths.astype(np.int64)            # stored as length-1
    if s.size == 0:
        out.append(Violation(
            "run-pairs", i, key, "run container with zero runs", member))
        return
    ends = s + l
    if int(s[0]) < 0 or bool(np.any(ends > 0xFFFF)):
        out.append(Violation(
            "run-range", i, key,
            "run exceeds the 16-bit chunk (start + length - 1 > 65535)",
            member))
    if s.size > 1 and not bool(np.all(s[1:] > ends[:-1])):
        out.append(Violation(
            "run-pairs", i, key, "runs out of order or overlapping", member))
    got = int((l + 1).sum())
    if got != card:
        out.append(Violation(
            "card-mismatch", i, key,
            f"run lengths sum to {got}, counter says {card}", member))


def audit_bitmap(rb: pr.RoaringBitmap, *,
                 canonical: bool = False) -> AuditReport:
    """Structurally audit a host ``RoaringBitmap``; see the module docstring
    for the invariant list. ``canonical=True`` also enforces the strict
    best-of-three kind rule (only guaranteed for set-algebra outputs)."""
    out: List[Violation] = []
    n = len(rb.keys)
    if len(rb.containers) != n:
        out.append(Violation(
            "structure", -1, -1,
            f"{n} keys but {len(rb.containers)} containers"))
        return AuditReport("RoaringBitmap", n, tuple(out))
    prev = -1
    for i, (k, c) in enumerate(zip(rb.keys, rb.containers)):
        k = int(k)
        if not 0 <= k <= 0xFFFF:
            out.append(Violation(
                "key-range", i, k, f"key {k} outside [0, 65536)"))
        if k <= prev:
            out.append(Violation(
                "key-order", i, k,
                f"key {k} not strictly greater than predecessor {prev}"))
        prev = k
        card = int(c.cardinality)
        if card == 0:
            out.append(Violation(
                "card-range", i, k, "empty container present in the index"))
            continue
        if isinstance(c, pr.RunContainer):
            _audit_runs(out, c.starts, c.lengths, card, i, k)
            if canonical:
                _check_canonical_kind(out, "run", card, c.n_runs, i, k)
        elif isinstance(c, pr.BitmapContainer):
            got = pr.popcount_words(c.words)
            if got != card:
                out.append(Violation(
                    "card-mismatch", i, k,
                    f"bitmap popcount {got}, counter says {card}"))
            elif canonical:
                _check_canonical_kind(
                    out, "bitmap", card,
                    _minimal_nruns_of_array(pr.bitmap_to_array(c.words)),
                    i, k)
        else:
            _audit_array(out, c.arr, card, i, k)
            if canonical:
                _check_canonical_kind(
                    out, "array", card, _minimal_nruns_of_array(c.arr), i, k)
    return AuditReport("RoaringBitmap", n, tuple(out))


def _audit_slab_member(out: List[Violation], keys, kinds, cards, nruns,
                       payload, member: int) -> int:
    from repro_torch.core import torch_roaring as jr

    C = keys.shape[-1]
    live = 0
    prev = -1
    sentinel = int(jr.KEY_SENTINEL)
    for i in range(C):
        k, kind, card = int(keys[i]), int(kinds[i]), int(cards[i])
        nr = int(nruns[i])
        if kind not in (jr.KIND_EMPTY, jr.KIND_ARRAY, jr.KIND_BITMAP,
                        jr.KIND_RUN):
            out.append(Violation(
                "kind-range", i, k, f"unknown kind tag {kind}", member))
            continue
        if kind == jr.KIND_EMPTY:
            if k != sentinel:
                out.append(Violation(
                    "key-order", i, k,
                    "empty row carries a live key (not the sentinel)",
                    member))
            if card != 0:
                out.append(Violation(
                    "card-mismatch", i, k,
                    f"empty row with cardinality counter {card}", member))
            continue
        live += 1
        if not 0 <= k <= 0xFFFF:
            out.append(Violation(
                "key-range", i, k, f"key {k} outside [0, 65536)", member))
        if k <= prev:
            out.append(Violation(
                "key-order", i, k,
                f"key {k} not strictly greater than predecessor {prev}",
                member))
        prev = k
        if card <= 0:
            out.append(Violation(
                "card-range", i, k,
                f"live row with cardinality counter {card}", member))
            continue
        row = payload[i]
        if kind == jr.KIND_ARRAY:
            _audit_array(out, row[:card], card, i, k, member)
        elif kind == jr.KIND_BITMAP:
            got = pr.popcount_words(np.ascontiguousarray(row).view(
                np.uint64))
            if got != card:
                out.append(Violation(
                    "card-mismatch", i, k,
                    f"bitmap popcount {got}, counter says {card}", member))
        else:
            if not 0 < nr <= jr.MAX_RUNS:
                out.append(Violation(
                    "run-pairs", i, k,
                    f"run row with nruns counter {nr} outside (0, "
                    f"{jr.MAX_RUNS}]", member))
                continue
            allp = row.astype(np.int64).reshape(-1, 2)
            n_valid = int(np.count_nonzero(allp[:, 0] + allp[:, 1]
                                           < (1 << 16)))
            if n_valid != nr:
                out.append(Violation(
                    "nruns-mismatch", i, k,
                    f"payload holds {n_valid} in-range run pairs, nruns "
                    f"counter says {nr}", member))
            pairs = row[:2 * nr].astype(np.int64)
            _audit_runs(out, pairs[0::2], pairs[1::2], card, i, k, member)
    return live


def audit_slab(slab, *, canonical: bool = False) -> AuditReport:
    """Structurally audit a device ``repro_torch.roaring.RoaringSlab``
    (host-side pass over the transferred arrays). Stacked slabs audit every
    member; ``Violation.member`` carries the batch index. ``canonical=True``
    checks the strict best-of-three kind rule per row (round-trips through
    ``to_roaring`` per live row — guaranteed only for engine outputs)."""
    keys = slab.keys.cpu().numpy()
    kinds = slab.kinds.cpu().numpy()
    cards = slab.cards.cpu().numpy()
    nruns = slab.nruns.cpu().numpy()
    payload = slab.payload.cpu().numpy().view(np.uint16)
    out: List[Violation] = []
    if keys.ndim == 1:
        members = [(keys, kinds, cards, nruns, payload, -1)]
    else:
        flat = keys.reshape(-1, keys.shape[-1]).shape[0]
        members = [
            (keys.reshape(flat, keys.shape[-1])[m],
             kinds.reshape(flat, keys.shape[-1])[m],
             cards.reshape(flat, keys.shape[-1])[m],
             nruns.reshape(flat, keys.shape[-1])[m],
             payload.reshape(flat, keys.shape[-1], payload.shape[-1])[m], m)
            for m in range(flat)]
    n_live = 0
    for mk, mkind, mcard, mnr, mpay, m in members:
        n_live += _audit_slab_member(out, mk, mkind, mcard, mnr, mpay, m)
        if canonical:
            for i in range(mk.shape[-1]):
                kind, card = int(mkind[i]), int(mcard[i])
                if kind == 0 or card <= 0:
                    continue
                row = mpay[i]
                if kind == 1:
                    mr = _minimal_nruns_of_array(row[:card])
                    _check_canonical_kind(out, "array", card, mr, i,
                                          int(mk[i]), m)
                elif kind == 2:
                    vals = pr.bitmap_to_array(
                        np.ascontiguousarray(row).view(np.uint64))
                    _check_canonical_kind(out, "bitmap", card,
                                          _minimal_nruns_of_array(vals), i,
                                          int(mk[i]), m)
                else:
                    nr = int(mnr[i])
                    _check_canonical_kind(out, "run", card, nr, i,
                                          int(mk[i]), m)
    return AuditReport("RoaringSlab", n_live, tuple(out))


def audit_page_table(table) -> AuditReport:
    """Audit a ``serve.kv_cache.RoaringPageTable``: the free pool plus the
    per-sequence page sets must exactly partition ``[0, n_pages)`` — a page
    in neither is *leaked*, a page in both (or in two sequences) is *double
    allocated* — and bookkeeping (``seq_len`` vs page count, list order vs
    set) must agree. The free bitmap is structurally audited too."""
    out: List[Violation] = []
    free = set(int(x) for x in table.free.to_array().tolist())
    seen: dict = {}
    for sid, pages in table.seq_pages.items():
        if len(set(pages)) != len(pages):
            out.append(Violation(
                "page-dup", -1, -1,
                f"sequence {sid} lists a page twice: {pages}"))
        for p in pages:
            if p in free:
                out.append(Violation(
                    "page-double-alloc", -1, -1,
                    f"page {p} of sequence {sid} is also in the free pool"))
            if p in seen:
                out.append(Violation(
                    "page-double-alloc", -1, -1,
                    f"page {p} allocated to sequences {seen[p]} and {sid}"))
            if not 0 <= p < table.n_pages:
                out.append(Violation(
                    "page-range", -1, -1,
                    f"page {p} of sequence {sid} outside [0, "
                    f"{table.n_pages})"))
            seen[p] = sid
        need = (table.seq_len.get(sid, 0) + table.page_size - 1) \
            // table.page_size
        if len(pages) < need:
            out.append(Violation(
                "page-accounting", -1, -1,
                f"sequence {sid} holds {len(pages)} pages for "
                f"{table.seq_len.get(sid, 0)} tokens (needs {need})"))
    missing = sorted(set(range(table.n_pages)) - free - set(seen))
    if missing:
        out.append(Violation(
            "page-leak", -1, -1,
            f"{len(missing)} page(s) neither free nor allocated: "
            f"{missing[:8]}" + ("..." if len(missing) > 8 else "")))
    for sid in table.seq_len:
        if sid not in table.seq_pages:
            out.append(Violation(
                "page-accounting", -1, -1,
                f"sequence {sid} has a length but no page list"))
    inner = audit_bitmap(table.free)
    out.extend(inner.violations)
    return AuditReport("RoaringPageTable", len(table.seq_pages), tuple(out))
