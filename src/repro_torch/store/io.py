"""Durable store streams — the ``BitmapStore`` container format (the port's
own copy of the reference package's format: the same bytes and the same
typed rejections).

Layout (all integers little-endian)::

    magic    8 bytes   b"RBSTORE1"
    u32      metadata length M
    M bytes  canonical JSON metadata: {"version": 1, "n_rows": N,
             "columns": [{"kind": "eq", "name": ..., "vkind": "int"|"str",
                          "values": [...sorted...]} |
                         {"kind": "bsi", "name": ..., "bits": b}, ...]}
    then, one entry per column slab in slot order (eq values in sorted
    order, bsi slices LSB first):
    u32      blob length L
    L bytes  a portable ``RoaringFormatSpec`` stream (the standard Roaring
             interchange format — each blob is independently readable by
             CRoaring / PyRoaring clients)

The universe and empty slots are not stored — they are derivable from
``n_rows``. Metadata is *canonical* JSON (sorted keys, no whitespace), and
``load_store`` rejects any stream whose metadata bytes differ from the
canonical re-dump of their parsed value — so every accepted stream re-saves
byte-identically, the same contract the slab codec keeps.

``load_store`` treats input as untrusted: every read is bounds-checked,
metadata is schema-validated (version, unique column names, sorted-unique
typed values, bit widths), each blob goes through the hardened
``RoaringFormatSpec.deserialize`` (with the caller's ``DecodeLimits``), and
each decoded posting must stay inside the declared row universe. Any
violation raises a typed ``StoreFormatError`` / ``RoaringFormatError`` —
never a bare struct/json/numpy error, and never a silently-wrong store.
"""

from __future__ import annotations

import json
import struct
from typing import List, Optional

import numpy as np

from repro_torch.core import py_roaring as pr
from repro_torch.roaring.format import (DecodeLimits, RoaringFormatError,
                                  RoaringFormatSpec)

__all__ = ["STORE_MAGIC", "MAX_STACK_CELLS", "StoreFormatError",
           "save_store", "load_store"]

STORE_MAGIC = b"RBSTORE1"

_MAX_META_BYTES = 1 << 24          # 16 MiB of metadata is already absurd
_MAX_BSI_BITS = 64
_MAX_ROWS = 1 << 32                # the 32-bit row universe slabs address
# stacked-slab cells (slabs x chunks) a load may materialize: the stack
# payload is cells x 8 KiB, so 2^17 cells caps the device allocation at
# 1 GiB.  Metadata declaring more (a forged n_rows near 2^32, or millions
# of posting values) is an allocation bomb, not a store. A caller that
# expects a larger store raises the cap with ``max_stack_cells``.
MAX_STACK_CELLS = 1 << 17


class StoreFormatError(RoaringFormatError):
    """A store stream violated the container-format contract (magic,
    metadata, blob framing, or posting/universe consistency). Subclasses
    ``RoaringFormatError``, so one ``except`` arm covers the whole load
    path — inner slab-blob violations keep their own typed classes."""


def _canon_meta(meta: dict) -> bytes:
    return json.dumps(meta, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def save_store(store) -> bytes:
    """``BitmapStore`` -> durable byte stream (format above)."""
    from repro_torch.store.store import BsiColumn, _RESERVED_SLOTS

    cols = []
    for c in store.columns:
        if isinstance(c, BsiColumn):
            cols.append({"kind": "bsi", "name": c.name, "bits": c.bits})
        else:
            cols.append({"kind": "eq", "name": c.name, "vkind": c.vkind,
                         "values": list(c.values)})
    meta = _canon_meta({"version": 1, "n_rows": store.n_rows,
                        "columns": cols})
    out = bytearray(STORE_MAGIC)
    out += struct.pack("<I", len(meta))
    out += meta
    for rb in store._bitmaps[_RESERVED_SLOTS:]:
        blob = RoaringFormatSpec.serialize(rb)
        out += struct.pack("<I", len(blob))
        out += blob
    return bytes(out)


def _need(data: bytes, pos: int, k: int, what: str) -> None:
    if pos + k > len(data):
        raise StoreFormatError(
            f"truncated store stream: {what} needs {k} bytes, "
            f"{len(data) - pos} remain", offset=pos)


def _check_meta(meta, offset: int) -> None:
    """Schema-validate parsed metadata; raise ``StoreFormatError`` on any
    shape violation (typed, with the metadata's byte offset)."""
    def bad(msg: str):
        raise StoreFormatError(f"bad store metadata: {msg}", offset=offset)

    if not isinstance(meta, dict):
        bad("top level is not an object")
    if set(meta) != {"version", "n_rows", "columns"}:
        bad(f"keys {sorted(meta)} != ['columns', 'n_rows', 'version']")
    if meta["version"] != 1:
        bad(f"unsupported version {meta['version']!r}")
    n_rows = meta["n_rows"]
    if not isinstance(n_rows, int) or isinstance(n_rows, bool) \
            or not 0 <= n_rows <= _MAX_ROWS:
        bad(f"n_rows {n_rows!r} outside [0, 2^32]")
    if not isinstance(meta["columns"], list) or not meta["columns"]:
        bad("columns must be a non-empty list")
    names = set()
    for ci, col in enumerate(meta["columns"]):
        if not isinstance(col, dict) or "kind" not in col \
                or "name" not in col or not isinstance(col["name"], str):
            bad(f"column {ci} malformed")
        if col["name"] in names:
            bad(f"duplicate column name {col['name']!r}")
        names.add(col["name"])
        if col["kind"] == "bsi":
            if set(col) != {"kind", "name", "bits"}:
                bad(f"bsi column {col['name']!r} keys {sorted(col)}")
            b = col["bits"]
            if not isinstance(b, int) or isinstance(b, bool) \
                    or not 1 <= b <= _MAX_BSI_BITS:
                bad(f"bsi column {col['name']!r} bits {b!r} outside "
                    f"[1, {_MAX_BSI_BITS}]")
        elif col["kind"] == "eq":
            if set(col) != {"kind", "name", "vkind", "values"}:
                bad(f"eq column {col['name']!r} keys {sorted(col)}")
            vkind, values = col["vkind"], col["values"]
            if vkind not in ("int", "str"):
                bad(f"eq column {col['name']!r} vkind {vkind!r}")
            if not isinstance(values, list):
                bad(f"eq column {col['name']!r} values not a list")
            want = str if vkind == "str" else int
            for v in values:
                if not isinstance(v, want) or isinstance(v, bool):
                    bad(f"eq column {col['name']!r} value {v!r} is not "
                        f"{vkind}")
            if any(values[i] >= values[i + 1]
                   for i in range(len(values) - 1)):
                bad(f"eq column {col['name']!r} values not sorted-unique")
        else:
            bad(f"column {col['name']!r} kind {col['kind']!r}")


def load_store(data: bytes, *, limits: Optional[DecodeLimits] = None,
               check: bool = False, max_stack_cells: int = MAX_STACK_CELLS,
               device=None):
    """Untrusted store stream -> ``BitmapStore`` on ``device`` (default: the
    card).

    Structural validation always runs; ``check=True`` additionally audits
    every decoded bitmap (``RoaringFormatSpec.deserialize(check=True)``).
    ``limits`` bounds each slab blob's decode (container count / bytes);
    ``max_stack_cells`` bounds slabs x chunks of the stacked slab.
    """
    from repro_torch.store.store import BitmapStore, BsiColumn, EqColumn

    _need(data, 0, len(STORE_MAGIC) + 4, "magic + metadata length")
    if data[:len(STORE_MAGIC)] != STORE_MAGIC:
        raise StoreFormatError(
            f"not a bitmap-store stream (magic {data[:8]!r})", offset=0)
    pos = len(STORE_MAGIC)
    (meta_len,) = struct.unpack_from("<I", data, pos)
    pos += 4
    if meta_len > _MAX_META_BYTES:
        raise StoreFormatError(
            f"metadata of {meta_len} bytes exceeds the {_MAX_META_BYTES}-"
            "byte ceiling", offset=pos - 4)
    _need(data, pos, meta_len, "metadata")
    meta_pos, raw = pos, data[pos:pos + meta_len]
    pos += meta_len
    try:
        meta = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise StoreFormatError(f"metadata is not valid JSON: {e}",
                               offset=meta_pos) from None
    _check_meta(meta, meta_pos)
    if _canon_meta(meta) != raw:
        raise StoreFormatError(
            "metadata is not canonical JSON (re-save would not be "
            "byte-identical)", offset=meta_pos)

    n_rows = meta["n_rows"]
    n_slabs = 2 + sum(col["bits"] if col["kind"] == "bsi"
                      else len(col["values"]) for col in meta["columns"])
    n_chunks = max(1, -(-n_rows // (1 << 16)))
    if n_slabs * n_chunks > max_stack_cells:
        raise StoreFormatError(
            f"store would stack {n_slabs} slabs x {n_chunks} chunks = "
            f"{n_slabs * n_chunks} cells, over the {max_stack_cells}-cell "
            f"({max_stack_cells * 8 // (1 << 20)} MiB payload) ceiling",
            offset=meta_pos)
    universe = pr.RoaringBitmap.from_ranges([(0, n_rows)]) if n_rows \
        else pr.RoaringBitmap()
    bitmaps: List[pr.RoaringBitmap] = [universe, pr.RoaringBitmap()]
    columns: List = []
    for col in meta["columns"]:
        base = len(bitmaps)
        if col["kind"] == "bsi":
            n_blobs = col["bits"]
            columns.append(BsiColumn(col["name"], col["bits"], base))
        else:
            n_blobs = len(col["values"])
            columns.append(EqColumn(col["name"], col["vkind"],
                                    tuple(col["values"]), base))
        for b in range(n_blobs):
            what = f"column {col['name']!r} slab {b}"
            _need(data, pos, 4, f"{what} length")
            (blob_len,) = struct.unpack_from("<I", data, pos)
            pos += 4
            _need(data, pos, blob_len, f"{what} payload")
            rb = RoaringFormatSpec.deserialize(
                data[pos:pos + blob_len], limits=limits, check=check)
            top = _max_value(rb)
            if top is not None and top >= n_rows:
                raise StoreFormatError(
                    f"{what} holds row id {top} outside the "
                    f"declared universe of {n_rows} rows", offset=pos)
            bitmaps.append(rb)
            pos += blob_len
    if pos != len(data):
        raise StoreFormatError(
            f"{len(data) - pos} trailing bytes after the last slab blob",
            offset=pos)
    return BitmapStore(n_rows, columns, bitmaps, device=device)


def _max_value(rb: pr.RoaringBitmap) -> Optional[int]:
    """Largest value of a decoded bitmap (its keys are strictly increasing,
    so it lies in the last container), or None when empty."""
    if not rb.keys:
        return None
    return (int(rb.keys[-1]) << 16) + int(rb.containers[-1].to_array()[-1])
