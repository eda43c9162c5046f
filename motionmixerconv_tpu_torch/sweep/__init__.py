"""Hyperparameter studies (the JAX package's ``sweep/``, ported)."""

from .engine import (
    GridSampler,
    MedianPruner,
    RandomSampler,
    Study,
    TPESampler,
    Trial,
    TrialPruned,
    create_study,
)
from .optuna_export import export_optuna_sqlite

__all__ = ["Study", "Trial", "TrialPruned", "GridSampler", "RandomSampler",
           "TPESampler", "MedianPruner", "create_study",
           "export_optuna_sqlite"]
