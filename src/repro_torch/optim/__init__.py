"""``repro_torch.optim`` — AdamW with the reference's f32 arithmetic,
updating the optimizer state and the parameters in place."""

from .optimizers import OptimizerDef, adamw, clip_by_global_norm, cosine_schedule

__all__ = ["OptimizerDef", "adamw", "clip_by_global_norm", "cosine_schedule"]
