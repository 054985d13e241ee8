"""``repro_torch.roaring`` — the public Roaring surface of the port.

One type, ``RoaringSlab``, with operator algebra (``&``, ``|``, ``^``,
``-``) byte-identical to the reference package and the ``py_roaring``
oracle, a leading batch axis for stacked slabs, and the N-way ``stack`` /
``union_all`` / ``intersect_all``. ``RoaringFormatSpec`` is the portable
serialization codec behind ``RoaringSlab.serialize`` / ``deserialize``,
which treats byte streams as untrusted (``RoaringFormatError`` with
byte-offset context, ``DecodeLimits`` caps). ``repro_torch.roaring.validate``
is the invariant auditor over host bitmaps, device slabs and the serving
page table.
"""

from repro_torch.core.torch_roaring import (ARRAY_MAX, CHUNK_BITS,
                                            CHUNK_SIZE, KEY_SENTINEL,
                                            KIND_ARRAY, KIND_BITMAP,
                                            KIND_EMPTY, KIND_RUN, MAX_RUNS,
                                            ROW_WORDS)
from repro_torch.roaring import validate
from repro_torch.roaring.format import (DecodeLimits, RoaringFormatError,
                                        RoaringFormatSpec)
from repro_torch.roaring.slab import (RoaringSlab, intersect_all, stack,
                                      union_all)
from repro_torch.roaring.validate import (AuditReport, InvariantViolation,
                                          Violation, audit_bitmap,
                                          audit_page_table, audit_slab)

__all__ = [
    "RoaringSlab", "RoaringFormatSpec",
    "stack", "union_all", "intersect_all",
    "RoaringFormatError", "DecodeLimits", "validate",
    "AuditReport", "Violation", "InvariantViolation",
    "audit_bitmap", "audit_slab", "audit_page_table",
    "CHUNK_BITS", "CHUNK_SIZE", "ARRAY_MAX", "ROW_WORDS", "MAX_RUNS",
    "KEY_SENTINEL", "KIND_EMPTY", "KIND_ARRAY", "KIND_BITMAP", "KIND_RUN",
]
