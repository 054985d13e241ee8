"""``repro_torch.optim`` — AdamW, Adafactor and 8-bit AdamW with the
reference's f32 arithmetic, updating the optimizer state and the
parameters in place."""

from .optimizers import (OptimizerDef, adafactor, adafactor_factored, adamw,
                         adamw8bit, clip_by_global_norm, cosine_schedule)

__all__ = ["OptimizerDef", "adafactor", "adafactor_factored", "adamw",
           "adamw8bit", "clip_by_global_norm", "cosine_schedule"]
