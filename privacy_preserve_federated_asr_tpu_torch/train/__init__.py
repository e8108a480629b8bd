from .checkpoint import CheckpointManager, load_state_dict
from .optim import STAGE_LRS, make_lr_schedule, make_optimizer
from .steps import (
    DeviceBatch,
    FeatureBatch,
    frontend_forward_fn,
    gather_features,
    make_eval_step,
    make_feature_train_step,
    make_train_step,
)
from .train_state import DACSTrainState, create_train_state
from .trainer import Trainer, TrainerConfig

__all__ = ["CheckpointManager", "DACSTrainState", "DeviceBatch", "FeatureBatch",
           "STAGE_LRS", "Trainer", "TrainerConfig", "create_train_state",
           "frontend_forward_fn", "gather_features", "load_state_dict",
           "make_eval_step", "make_feature_train_step", "make_lr_schedule",
           "make_optimizer", "make_train_step"]
