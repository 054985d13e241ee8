"""RLE-based compressed bitmap baselines the paper compares against (the
port's own numpy copy of the reference's ``baselines``, byte for byte in
behaviour; nothing here runs on the card).

WAH (Wu et al.) and Concise (Colantonio & Di Pietro) are implemented from the
format definitions in the paper's S1; BitSet mirrors java.util.BitSet's
doubling allocation. All three expose the same small API:

    from_array(values) / to_array()
    and_(other) / or_(other)          -> new object
    append(x)   (x > max, Fig. 2e)    remove(x)  (Fig. 2f)
    size_in_bytes()

Two op engines are provided for the RLE formats:
  * ``engine="expanded"`` (default): vectorized decode -> word-wise op ->
    re-encode. Favorable to WAH/Concise on modern hardware (numpy SIMD), so
    Roaring's measured advantage is conservative.
  * ``engine="streaming"``: the faithful run-at-a-time merge of the original
    algorithms, with a words-touched counter for machine-independent cost.
"""

from .wah import WahBitmap
from .concise import ConciseBitmap
from .bitset import BitSet

__all__ = ["WahBitmap", "ConciseBitmap", "BitSet"]
