from .step import (TrainState, import_dynamo_off_stack, init_train_state,
                   make_train_step, move_batch)

__all__ = ["TrainState", "import_dynamo_off_stack", "init_train_state",
           "make_train_step", "move_batch"]
