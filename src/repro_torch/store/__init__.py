"""``repro_torch.store`` — columnar bitmap-index store + predicate compiler.

Ingest columnar records into per-(column, value) Roaring posting slabs
(equality columns) and bit-sliced-index slabs (integer range / aggregate
columns), then answer ``eq / in_ / range_ / and_ / or_ / not_`` predicate
queries by compiling them into ``repro_torch.index`` expression trees over
ONE key-aligned stacked slab on the card. ``save`` / ``load`` serialize
each slab through the portable ``RoaringFormatSpec`` codec with the
hardened parser on the load path.

Quick tour::

    from repro_torch import store

    s = store.BitmapStore.build(records, bsi=("age",))   # device="cpu" too
    rows = s.query(store.and_(store.eq("sex", 1),
                              store.range_("age", 30, 40)), fused=True)
    n = s.count(store.not_(store.in_("state", [3, 7])))
    blob = s.save()
    s2 = store.BitmapStore.load(blob)      # typed rejection on bad bytes
"""

from repro_torch.store.io import STORE_MAGIC, StoreFormatError
from repro_torch.store.predicate import (AndP, Eq, In, NotP, OrP, Pred,
                                         Range, and_, eq, in_, not_, or_,
                                         range_)
from repro_torch.store.store import (EMPTY_SLOT, UNIVERSE_SLOT, BitmapStore,
                                     BsiColumn, EqColumn)

__all__ = [
    "BitmapStore", "EqColumn", "BsiColumn",
    "Pred", "Eq", "In", "Range", "AndP", "OrP", "NotP",
    "eq", "in_", "range_", "and_", "or_", "not_",
    "StoreFormatError", "STORE_MAGIC",
    "UNIVERSE_SLOT", "EMPTY_SLOT",
]
