from .checkpoint import CheckpointManager, load_params, load_state_dict, save_params
from .optim import STAGE_LRS, make_lr_schedule, make_optimizer
from .steps import (
    DeviceBatch,
    FeatureBatch,
    HiddenBatch,
    backbone_forward_fn,
    frontend_forward_fn,
    gather_features,
    gather_hidden,
    make_eval_step,
    make_feature_train_step,
    make_hidden_eval_step,
    make_hidden_train_step,
    make_multitask_train_step,
    make_train_step,
)
from .prefetch import prefetch_device_batches, prefetch_iter
from .train_state import DACSTrainState, create_train_state
from .trainer import Trainer, TrainerConfig

__all__ = ["CheckpointManager", "DACSTrainState", "DeviceBatch", "FeatureBatch",
           "HiddenBatch", "STAGE_LRS", "Trainer", "TrainerConfig", "backbone_forward_fn",
           "create_train_state", "frontend_forward_fn", "gather_features",
           "gather_hidden", "load_params", "load_state_dict", "make_eval_step",
           "make_feature_train_step", "make_hidden_eval_step", "make_hidden_train_step",
           "make_lr_schedule", "make_multitask_train_step", "make_optimizer",
           "make_train_step", "prefetch_device_batches", "prefetch_iter", "save_params"]
