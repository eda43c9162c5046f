from .autoreg_trainer import AutoregressiveTrainer
from .autoregressive import autoregressive_rollout, rollout_starts
from .loop import Trainer
from .optim import Optimizer, make_optimizer
from .state import restore_checkpoint, save_checkpoint

__all__ = [
    "AutoregressiveTrainer",
    "autoregressive_rollout",
    "rollout_starts",
    "Trainer",
    "Optimizer",
    "make_optimizer",
    "save_checkpoint",
    "restore_checkpoint",
]
