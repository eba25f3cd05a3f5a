from .checkpoint import (CheckpointManager, load_params_from_path, load_pretrained,
                         load_torch_checkpoint, save_reference_checkpoint)
from .optim import Optimizer, build_optimizer, update_milestones_from_microsteps
from .train_step import TrainState, make_train_step
from .trainer import Trainer

__all__ = [
    "CheckpointManager",
    "Optimizer",
    "TrainState",
    "Trainer",
    "build_optimizer",
    "load_params_from_path",
    "load_pretrained",
    "load_torch_checkpoint",
    "make_train_step",
    "save_reference_checkpoint",
    "update_milestones_from_microsteps",
]
