from .step import (TrainConfig, init_train_state, make_decode_step,
                   make_prefill_step, make_train_step)

__all__ = ["TrainConfig", "init_train_state", "make_decode_step",
           "make_prefill_step", "make_train_step"]
