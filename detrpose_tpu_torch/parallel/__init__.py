"""The training step (single device)."""
from .train_step import TrainStep, make_train_step

__all__ = ["TrainStep", "make_train_step"]
