"""Training (the train step) and serving steps."""
from .train_step import TrainState, make_train_step, train_state_init

__all__ = ["TrainState", "make_train_step", "train_state_init"]
