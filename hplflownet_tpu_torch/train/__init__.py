"""Training of the port: the train/eval steps (Adam), LR schedules,
checkpoints, metrics and the train/evaluate driver (``train.driver``)."""

from .schedule import lr_at_epoch, make_lr_schedule  # noqa: F401
from .step import (AdamState, TrainState, create_train_state,  # noqa: F401
                   make_eval_step, make_train_step, set_learning_rate)
from .metrics import evaluate_3d, evaluate_2d  # noqa: F401
