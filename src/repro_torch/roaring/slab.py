"""``RoaringSlab`` — the Roaring container object over torch tensors.

A frozen dataclass whose leaves are the slab tensors (``keys`` / ``kinds``
/ ``cards`` / ``nruns`` / ``payload``, all on one device) and whose static
``C`` is the container capacity. A single slab has ``keys: i32[C]``
(``ndim == 1``); a stacked slab — N key-aligned slabs — is the same type
with ``keys: i32[N, C]`` (``ndim == 2``), indexed ``stack[i]``.

``from_numpy`` takes the reference package's slab leaves as numpy arrays,
so the exact bytes of a reference index can be loaded into the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core import torch_roaring as tr
from repro_torch.roaring.format import RoaringFormatSpec

__all__ = ["RoaringSlab"]

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
    def from_roaring(cls, rb, capacity: int, *, device=None) -> "RoaringSlab":
        """Host ``py_roaring.RoaringBitmap`` -> slab, kind-preserving."""
        return _wrap(tr.from_roaring(rb, capacity, _device.resolve(device)))

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
        (default: the cardinality; 1-D only)."""
        self._require_single("to_indices")
        return tr.to_indices(_to_internal(self), max_out)

    # -- scalar accounting ----------------------------------------------------
    def card(self) -> torch.Tensor:
        """Total cardinality; ``i64[]`` for a single slab, ``i64[N]`` per
        stacked member."""
        return self.cards.sum(dim=-1, dtype=torch.int64)

    def _require_single(self, what: str) -> None:
        if self.ndim != 1:
            raise ValueError(f"{what} needs a single slab (ndim == 1); "
                             f"index a stacked slab first, e.g. s[i]")

    def __repr__(self) -> str:
        batch = "x".join(str(b) for b in self.batch_shape)
        return (f"RoaringSlab(C={self.C}"
                + (f", batch=[{batch}]" if batch else "") + f", {self.device})")
