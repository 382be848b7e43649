from .step import TrainState, init_train_state, make_train_step, move_batch

__all__ = ["TrainState", "init_train_state", "make_train_step",
           "move_batch"]
