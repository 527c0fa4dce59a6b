"""Training and serving of the port (counterpart of ``repro/train``)."""

from .state import TrainState, init_train_state  # noqa: F401
from .step import (make_eval_step, make_prefill_step, make_serve_step,  # noqa: F401
                   make_train_step)
from .trainer import Trainer, TrainerConfig  # noqa: F401
