"""Training substrate: step builder, fault-tolerant loop, straggler watch."""

from .loop import LoopConfig, TrainLoop
from .step import TrainState, build_train_step, init_train_state

__all__ = ["TrainState", "build_train_step", "init_train_state",
           "TrainLoop", "LoopConfig"]
