"""Shape grid shared by the architecture configs:

  * train_4k    : train_step,  seq 4096,   global batch 256
  * prefill_32k : prefill,     seq 32768,  global batch 32
  * decode_32k  : serve_step (1 new token, KV cache 32768), batch 128
  * long_500k   : serve_step (1 new token, KV/state 524288), batch 1
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}
