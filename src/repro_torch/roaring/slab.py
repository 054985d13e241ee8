"""``RoaringSlab`` — the Roaring container object over torch tensors.

A frozen dataclass whose leaves are the slab tensors (``keys`` / ``kinds``
/ ``cards`` / ``nruns`` / ``payload``, all on one device) and whose static
``C`` is the container capacity. A single slab has ``keys: i32[C]``
(``ndim == 1``); a stacked slab — N key-aligned slabs — is the same type
with ``keys: i32[N, C]`` (``ndim == 2``), indexed ``stack[i]``.

Every operator and method broadcasts over a leading batch axis as the
reference's do: where the reference vmaps, the port loops over the members
(each member runs the same engine path on its own rows, so each keeps its
own key alignment and canonicalization) and stacks the results. Set-algebra
outputs are canonical (strict best-of-three per row) and byte-identical to
the reference package and the ``py_roaring`` oracle.

``from_numpy`` takes the reference package's slab leaves as numpy arrays,
so the exact bytes of a reference index can be loaded into the port.
Constructors take ``device=None`` for the card and raise without one; pass
``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core import torch_roaring as tr
from repro_torch.roaring.format import RoaringFormatSpec

__all__ = ["RoaringSlab", "stack", "union_all", "intersect_all"]

SlabLike = Union["RoaringSlab", tr.RoaringSlab]


def _to_internal(s: SlabLike) -> tr.RoaringSlab:
    """Object -> internal row-state NamedTuple view (no copy). 1-D only."""
    if isinstance(s, RoaringSlab):
        return tr.RoaringSlab(keys=s.keys, card=s.cards, kind=s.kinds,
                              data=s.payload)
    return s


def _wrap(t: tr.RoaringSlab) -> "RoaringSlab":
    """Internal NamedTuple -> object (recomputes the nruns leaf)."""
    return RoaringSlab(keys=t.keys, kinds=t.kind, cards=t.card,
                       nruns=tr._rows_nruns(t.data, t.kind), payload=t.data,
                       C=t.keys.shape[-1])


def _as_object(s: SlabLike) -> "RoaringSlab":
    return s if isinstance(s, RoaringSlab) else _wrap(s)


def _batch_shape(s: SlabLike) -> Tuple[int, ...]:
    return tuple(s.keys.shape[:-1])


def _stack_results(outs: list):
    if isinstance(outs[0], RoaringSlab):
        C = outs[0].C
        if any(o.C != C for o in outs):
            raise ValueError("members produced different capacities")
        return RoaringSlab(*(torch.stack([getattr(o, f) for o in outs])
                             for f in _LEAVES), C=C)
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(xs) for xs in zip(*outs))
    return torch.stack(outs)


def _broadcast_map(f, operands: Sequence[SlabLike]):
    """Apply ``f`` (defined over 1-D object slabs) across leading batch axes
    by looping over the members; unbatched operands are shared by every
    member. All batched operands must share one batch shape."""
    shapes = {_batch_shape(s) for s in operands if _batch_shape(s)}
    if len(shapes) > 1:
        raise ValueError(f"mismatched slab batch shapes: {sorted(shapes)}")
    objs = [_as_object(s) for s in operands]
    if not shapes:
        return f(*objs)
    n = shapes.pop()[0]
    return _stack_results([
        _broadcast_map(f, [o[m] if o.ndim > 1 else o for o in objs])
        for m in range(n)])


_LEAVES = ("keys", "kinds", "cards", "nruns", "payload")


@dataclasses.dataclass(frozen=True, eq=False)
class RoaringSlab:
    """Static-capacity Roaring bitmap with ``C`` container rows.

    * ``keys    i32[..., C]``          sorted chunk keys, ``KEY_SENTINEL`` pad
    * ``kinds   i32[..., C]``          0 empty / 1 array / 2 bitmap / 3 run
    * ``cards   i32[..., C]``          per-container cardinalities
    * ``nruns   i32[..., C]``          per-row run counts (0 for non-run rows)
    * ``payload int16[..., C, 4096]``  8 kB rows (u16 bit patterns): packed
      arrays / bitmap words / ``(start, len-1)`` run pairs
    """

    keys: torch.Tensor
    kinds: torch.Tensor
    cards: torch.Tensor
    nruns: torch.Tensor
    payload: torch.Tensor
    C: int

    # -- static shape facts ---------------------------------------------------
    @property
    def capacity(self) -> int:
        """Static container capacity ``C``."""
        return self.C

    @property
    def ndim(self) -> int:
        """1 for a single slab, 2 for a stacked slab."""
        return self.keys.ndim

    @property
    def device(self) -> torch.device:
        return self.keys.device

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.keys.shape[:-1])

    @property
    def n_slabs(self) -> int:
        """Leading-axis length of a stacked slab."""
        if self.ndim < 2:
            raise ValueError("n_slabs needs a stacked slab (ndim >= 2)")
        return self.keys.shape[0]

    def __getitem__(self, i) -> "RoaringSlab":
        """Slice the leading batch axis (stacked slab -> member slab)."""
        if self.ndim < 2:
            raise IndexError("cannot index a single slab (ndim == 1)")
        return RoaringSlab(keys=self.keys[i], kinds=self.kinds[i],
                           cards=self.cards[i], nruns=self.nruns[i],
                           payload=self.payload[i], C=self.C)

    # -- constructors ---------------------------------------------------------
    @classmethod
    def empty(cls, capacity: int, *, device=None) -> "RoaringSlab":
        """All-empty slab — the identity of ``|`` and ``union_all``."""
        return _wrap(tr.empty(capacity, _device.resolve(device)))

    @classmethod
    def from_indices(cls, idx: torch.Tensor, valid: torch.Tensor,
                     capacity: int) -> "RoaringSlab":
        """(Padded) sorted unique integer indices -> slab on their device."""
        return _wrap(tr.from_indices(idx, valid, capacity))

    @classmethod
    def from_values(cls, values: np.ndarray, capacity: int, max_elems: int,
                    *, device=None) -> "RoaringSlab":
        """Host numpy integer values -> slab (pads to ``max_elems``)."""
        return _wrap(tr.from_dense_array(values, capacity, max_elems,
                                         _device.resolve(device)))

    @classmethod
    def from_numpy(cls, keys: np.ndarray, kinds: np.ndarray,
                   cards: np.ndarray, nruns: np.ndarray, payload: np.ndarray,
                   *, device=None) -> "RoaringSlab":
        """Slab leaves as numpy arrays (e.g. ``np.asarray`` of a reference
        slab's leaves; payload u16 or int16) -> slab on ``device`` (default:
        the card). The payload bytes are carried over unchanged."""
        dev = _device.resolve(device)
        payload = np.ascontiguousarray(payload)
        if payload.dtype not in (np.uint16, np.int16):
            raise ValueError(f"payload must be u16/int16, got {payload.dtype}")
        keys = np.asarray(keys)
        shape = keys.shape
        for name, a in (("kinds", kinds), ("cards", cards), ("nruns", nruns)):
            if np.shape(a) != shape:
                raise ValueError(f"{name} shape {np.shape(a)} != keys shape "
                                 f"{shape}")
        if payload.shape != shape + (tr.ROW_WORDS,):
            raise ValueError(f"payload shape {payload.shape} does not match "
                             f"keys shape {shape}")

        def t(a):
            return torch.from_numpy(np.array(a, np.int32)).to(dev)

        if not payload.flags.writeable:        # torch wants writable memory
            payload = payload.copy()

        return cls(keys=t(keys), kinds=t(kinds), cards=t(cards),
                   nruns=t(nruns),
                   payload=torch.from_numpy(payload.view(np.int16)).to(dev),
                   C=int(shape[-1]))

    @classmethod
    def from_roaring(cls, rb, capacity: int, *, check: bool = False,
                     device=None) -> "RoaringSlab":
        """Host ``py_roaring.RoaringBitmap`` -> slab, kind-preserving (run
        containers land as run rows). ``check=True`` audits the built slab
        (``repro_torch.roaring.validate``) and raises ``InvariantViolation``
        on any structural breach."""
        slab = _wrap(tr.from_roaring(rb, capacity, _device.resolve(device)))
        if check:
            from repro_torch.roaring import validate as _v
            _v.audit_slab(slab).raise_on_violation()
        return slab

    @classmethod
    def from_ranges(cls, ranges: Iterable[Tuple[int, int]], capacity: int,
                    *, device=None) -> "RoaringSlab":
        """Half-open ``[start, end)`` integer ranges -> run-row slab."""
        return _wrap(tr.from_ranges(ranges, capacity,
                                    _device.resolve(device)))

    @classmethod
    def deserialize(cls, data: bytes, capacity: Optional[int] = None, *,
                    limits=None, check: bool = False,
                    device=None) -> "RoaringSlab":
        """Untrusted portable Roaring byte stream -> slab (see
        ``RoaringFormatSpec``). ``capacity`` defaults to the container count
        in the stream. Structural stream validation always runs;
        ``check=True`` also audits the decoded bitmap and the built slab."""
        rb = RoaringFormatSpec.deserialize(data, limits=limits, check=check)
        if capacity is None:
            capacity = max(1, len(rb.keys))
        elif capacity < len(rb.keys):
            from repro_torch.roaring.format import DecodeLimitError
            raise DecodeLimitError(
                f"stream holds {len(rb.keys)} containers, caller capacity "
                f"is {capacity}")
        return cls.from_roaring(rb, capacity, check=check, device=device)

    # -- exporters ------------------------------------------------------------
    def to_roaring(self):
        """Slab -> host ``RoaringBitmap``, kind-preserving (1-D only)."""
        self._require_single("to_roaring")
        return tr.to_roaring(_to_internal(self))

    def serialize(self) -> bytes:
        """Slab -> portable Roaring byte stream (host-side)."""
        self._require_single("serialize")
        return RoaringFormatSpec.serialize(self.to_roaring())

    def to_indices(self, max_out: Optional[int] = None):
        """``(sorted values i64, valid bool)`` padded to ``max_out``
        (default: the cardinality, which a stacked slab cannot use)."""
        if max_out is None:
            self._require_single("to_indices without max_out")
        return _broadcast_map(
            lambda s: tr.to_indices(_to_internal(s), max_out), [self])

    def to_dense(self, universe: Optional[int] = None) -> np.ndarray:
        """Host dense ``bool[universe]`` membership vector (1-D only;
        ``universe`` defaults to the tightest chunk-aligned bound)."""
        self._require_single("to_dense")
        vals = self.to_roaring().to_array()
        if universe is None:
            hi = int(vals[-1]) + 1 if vals.size else 0
            universe = ((hi + tr.CHUNK_SIZE - 1) // tr.CHUNK_SIZE) \
                * tr.CHUNK_SIZE
        out = np.zeros((universe,), bool)
        out[vals[vals < universe]] = True
        return out

    # -- scalar accounting ----------------------------------------------------
    def card(self) -> torch.Tensor:
        """Total cardinality; ``i64[]`` for a single slab, ``i64[N]`` per
        stacked member."""
        return self.cards.sum(dim=-1, dtype=torch.int64)

    def n_containers(self) -> torch.Tensor:
        """# live container rows."""
        return (self.kinds != tr.KIND_EMPTY).sum(dim=-1, dtype=torch.int64)

    def size_in_bytes(self) -> torch.Tensor:
        """Exact serialized-size accounting: an 8-byte header + 4 bytes per
        container + 2·card / 8192 / 4·n_runs payload bytes (equals the
        oracle's ``size_in_bytes``)."""
        k = self.kinds
        payload = torch.where(
            k == tr.KIND_ARRAY, 2 * self.cards,
            torch.where(k == tr.KIND_BITMAP, 2 * tr.ROW_WORDS,
                        torch.where(k == tr.KIND_RUN, 4 * self.nruns, 0)))
        live = (k != tr.KIND_EMPTY).to(torch.int64)
        return 8 + (live * (4 + payload)).sum(dim=-1)

    # -- membership / rank / select -------------------------------------------
    def contains(self, queries) -> torch.Tensor:
        """Batched membership test — per-kind probes, log-bounded traffic."""
        return _broadcast_map(
            lambda s: tr.contains(_to_internal(s), queries), [self])

    def rank(self, x) -> torch.Tensor:
        """# elements <= x."""
        return _broadcast_map(lambda s: tr.rank(_to_internal(s), x), [self])

    def select(self, j) -> torch.Tensor:
        """Value of the j-th (0-based) smallest element; -1 out of range."""
        return _broadcast_map(
            lambda s: tr.slab_select(_to_internal(s), j), [self])

    def run_optimize(self) -> "RoaringSlab":
        """``runOptimize``: re-canonicalize every row best-of-three."""
        return _broadcast_map(
            lambda s: _wrap(tr.slab_run_optimize(_to_internal(s))), [self])

    # -- set algebra (kind-dispatch engine; canonical outputs) ----------------
    def _binary(self, other: SlabLike, impl,
                capacity: Optional[int]) -> "RoaringSlab":
        return _broadcast_map(
            lambda a, b: _wrap(impl(_to_internal(a), _to_internal(b),
                                    capacity=capacity)),
            [self, other])

    def and_(self, other: SlabLike,
             capacity: Optional[int] = None) -> "RoaringSlab":
        """A ∩ B over the registry's 4x4 dispatch grid. Output capacity
        defaults to ``min(C_a, C_b)`` (always sufficient)."""
        return self._binary(other, tr.slab_and, capacity)

    def or_(self, other: SlabLike,
            capacity: Optional[int] = None) -> "RoaringSlab":
        """A ∪ B. Output capacity defaults to ``C_a + C_b``."""
        return self._binary(other, tr.slab_or, capacity)

    def xor(self, other: SlabLike,
            capacity: Optional[int] = None) -> "RoaringSlab":
        """A ⊕ B (symmetric difference)."""
        return self._binary(other, tr.slab_xor, capacity)

    def andnot(self, other: SlabLike,
               capacity: Optional[int] = None) -> "RoaringSlab":
        """A \\ B. Output capacity defaults to ``C_a``."""
        return self._binary(other, tr.slab_andnot, capacity)

    __and__ = and_
    __or__ = or_
    __xor__ = xor
    __sub__ = andnot

    def and_card(self, other: SlabLike) -> torch.Tensor:
        """|A ∩ B| with no result slab (the dispatch kernel's cards)."""
        return _broadcast_map(
            lambda a, b: tr.slab_and_card(_to_internal(a), _to_internal(b)),
            [self, other])

    def or_card(self, other: SlabLike) -> torch.Tensor:
        """|A ∪ B| by inclusion-exclusion on the counters."""
        return _broadcast_map(
            lambda a, b: tr.slab_or_card(_to_internal(a), _to_internal(b)),
            [self, other])

    def jaccard(self, other: SlabLike) -> torch.Tensor:
        """|A∩B| / |A∪B| (float32; 0 when both are empty)."""
        return _broadcast_map(
            lambda a, b: tr.slab_jaccard(_to_internal(a), _to_internal(b)),
            [self, other])

    # -- internals ------------------------------------------------------------
    def _require_single(self, what: str) -> None:
        if self.ndim != 1:
            raise ValueError(f"{what} needs a single slab (ndim == 1); "
                             f"index a stacked slab first, e.g. s[i]")

    def __repr__(self) -> str:
        batch = "x".join(str(b) for b in self.batch_shape)
        return (f"RoaringSlab(C={self.C}"
                + (f", batch=[{batch}]" if batch else "") + f", {self.device})")


def stack(slabs: Sequence[SlabLike], capacity: Optional[int] = None,
          align: bool = True) -> RoaringSlab:
    """Stack N single slabs into one batched ``RoaringSlab`` (leading axis
    N).

    ``align=True`` (the wide-query layout): the merged key set over all N
    slabs is computed once and every slab's rows are gathered key-aligned
    in native container form. ``capacity`` must cover the merged distinct
    key count (defaults to the sum of input capacities). ``align=False``
    stacks the raw tensors (same capacity required).
    """
    if not slabs:
        raise ValueError("stack needs at least one slab")
    objs = [_as_object(s) for s in slabs]
    if any(o.ndim != 1 for o in objs):
        raise ValueError("stack expects single (ndim == 1) slabs")
    if not align:
        if capacity is not None and any(o.C != capacity for o in objs):
            raise ValueError("align=False cannot change capacities")
        if len({o.C for o in objs}) > 1:
            raise ValueError("align=False needs equal-capacity slabs")
        return _stack_results(objs)
    if capacity is None:
        capacity = sum(o.C for o in objs)
    keys = tr._merge_keys_many([o.keys for o in objs], capacity)
    gathered = [tr._gather_raw(_to_internal(o), keys) for o in objs]
    return RoaringSlab(
        keys=keys.expand(len(objs), capacity).contiguous(),
        kinds=torch.stack([g[2] for g in gathered]),
        cards=torch.stack([g[1] for g in gathered]),
        nruns=torch.stack([tr._rows_nruns(g[0], g[2]) for g in gathered]),
        payload=torch.stack([g[0] for g in gathered]), C=capacity)


def _union_all_single(slabs: List[RoaringSlab],
                      capacity: Optional[int]) -> RoaringSlab:
    cap = capacity if capacity is not None else max(
        1, sum(s.C for s in slabs))
    return _wrap(tr.union_many_slabs([_to_internal(s) for s in slabs], cap))


def union_all(slabs: Sequence[SlabLike], capacity: Optional[int] = None, *,
              device=None) -> RoaringSlab:
    """N-way union (Algorithm 4): the log-depth tree reduction with deferred
    cardinality and ONE canonicalization at the root.

    ``slabs`` may be single slabs (returns a single slab) or equal-batch
    stacked slabs (one reduction per member, stacked). No slabs gives an
    empty slab on ``device``.
    """
    slabs = [_as_object(s) for s in slabs]
    if not slabs:
        return RoaringSlab.empty(capacity or 1, device=device)
    return _broadcast_map(
        lambda *ss: _union_all_single(list(ss), capacity), slabs)


def intersect_all(slabs: Sequence[SlabLike],
                  capacity: Optional[int] = None) -> RoaringSlab:
    """N-way intersection: log-depth tree of dispatch steps with a single
    deferred canonicalization (batched like ``union_all``).

    Alignment uses the *intersected* key set (at most ``min(C_i)`` keys).
    An explicit ``capacity`` is applied after the reduction and
    canonicalization, when dead rows have been keyed out and live rows
    sorted first, so it bounds live result rows, never the pre-reduction
    shared-key count.
    """
    slabs = [_as_object(s) for s in slabs]
    if not slabs:
        raise ValueError("intersect_all needs at least one slab")

    def one(*ss: RoaringSlab) -> RoaringSlab:
        cap_full = min(s.C for s in ss)
        keys = ss[0].keys
        for s in ss[1:]:
            pos = torch.searchsorted(s.keys.contiguous(), keys.contiguous())
            hit = ((s.keys[pos.clamp(max=s.C - 1)] == keys)
                   & (keys != tr.KEY_SENTINEL))
            keys = torch.sort(torch.where(hit, keys, tr.KEY_SENTINEL)).values
        keys = tr._pad_keys(keys.to(torch.int32), cap_full)
        gathered = [tr._gather_raw(_to_internal(s), keys) for s in ss]
        data, card, kind = tr._tree_reduce_rows(
            torch.stack([g[0] for g in gathered]),
            torch.stack([g[1] for g in gathered]),
            torch.stack([g[2] for g in gathered]), tr._and_rows)
        out = tr._finalize_rows(keys, data, card, kind)
        if capacity is not None and capacity != cap_full:
            out = _resize_rows(out, capacity)
        return _wrap(out)

    return _broadcast_map(one, slabs)


def _resize_rows(t: tr.RoaringSlab, capacity: int) -> tr.RoaringSlab:
    """Resize a canonicalized (live-rows-first) internal slab to
    ``capacity`` rows: slice when shrinking, pad with empty rows
    (``KEY_SENTINEL`` / kind 0 / card 0 / zero payload) when growing."""
    C = t.keys.shape[-1]
    if capacity <= C:
        return tr.RoaringSlab(keys=t.keys[:capacity], card=t.card[:capacity],
                              kind=t.kind[:capacity],
                              data=t.data[:capacity])
    pad = tr.empty(capacity - C, t.keys.device)
    return tr.RoaringSlab(*(torch.cat([x, y]) for x, y in zip(t, pad)))
