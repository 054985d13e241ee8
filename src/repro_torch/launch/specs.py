"""What a launcher needs to know of a cell (architecture x input shape):
the optimizer the reference picks, the model's inputs and the training
microbatch.

The reference's ``launch/specs.py`` also lowers each cell to an XLA
program over a TPU mesh (``build_cell``) and reads ``REPRO_*`` experiment
knobs; neither has a counterpart here (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptimizerDef, adafactor, adamw, cosine_schedule

GIANT_PARAM_THRESHOLD = 50e9          # above this: adafactor (factored stats)
ENC_FRAMES = 256                      # audio stub frames (whisper)
VIS_TOKENS = 64                       # vision stub patches (qwen2-vl)


def pick_optimizer(cfg: ModelConfig) -> OptimizerDef:
    """The reference's choice: Adafactor above ``GIANT_PARAM_THRESHOLD``
    parameters, else AdamW, both on a cosine schedule (peak 3e-4, 2,000
    warm-up steps, 100,000 in all)."""
    lr = cosine_schedule(3e-4, warmup=2000, total=100_000)
    if cfg.param_count() > GIANT_PARAM_THRESHOLD:
        return adafactor(lr)
    return adamw(lr)


def input_specs(arch: str, shape: str) -> dict:
    """name -> (shape, torch dtype) of every model input of the cell, as
    the reference's ``input_specs``:

    train:   {tokens, mask[, extra_embeds][, memory]}
    prefill: {tokens[, extra_embeds][, memory]}
    decode:  {tokens (B, 1), pos (B,)[, memory]}  (caches built separately)
    """
    cfg = get_config(arch)
    spec = SHAPES[shape]
    B, S = spec.global_batch, spec.seq_len
    out: dict = {}
    if spec.kind == "train":
        out["tokens"] = ((B, S + 1), torch.int32)
        out["mask"] = ((B, S + 1), torch.float32)
    elif spec.kind == "prefill":
        out["tokens"] = ((B, S), torch.int32)
    else:
        out["tokens"] = ((B, 1), torch.int32)
        out["pos"] = ((B,), torch.int32)
    if cfg.frontend == "vision" and spec.kind == "train":
        out["extra_embeds"] = ((B, VIS_TOKENS, cfg.d_model), torch.bfloat16)
    if cfg.layer_pattern == "encdec":
        out["memory"] = ((B, ENC_FRAMES, cfg.d_model), torch.bfloat16)
    return out


def train_microbatch(cfg: ModelConfig, global_batch: int,
                     data_shards: int) -> Optional[int]:
    """The reference's gradient-accumulation rule for wide models: about
    two sequences per data shard per microstep (one at d_model >= 8,000),
    halved until it divides the global batch; ``None`` (no accumulation)
    below d_model 4,096."""
    if cfg.d_model < 4096:
        return None
    micro = max(data_shards * 2 // (1 if cfg.d_model < 8000 else 2),
                data_shards)
    while global_batch % micro:
        micro //= 2
    return micro
