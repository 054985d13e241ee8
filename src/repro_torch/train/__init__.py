"""``repro_torch.train`` — the train step and the single-host loop."""

from .trainer import TrainState, make_train_step, train_loop

__all__ = ["TrainState", "make_train_step", "train_loop"]
