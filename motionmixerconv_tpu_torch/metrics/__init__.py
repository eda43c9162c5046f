"""Losses and evaluation metrics (PyTorch)."""

from .metrics import (
    auc_pck_from_dist,
    auc_pck_metric,
    criterion_cos,
    criterion_cos2,
    delta_2_gt,
    euler_error,
    joint_angle_error,
    l1_angle_loss,
    mpjpe_error,
    pck,
)

__all__ = [
    "criterion_cos",
    "criterion_cos2",
    "mpjpe_error",
    "pck",
    "auc_pck_from_dist",
    "auc_pck_metric",
    "joint_angle_error",
    "euler_error",
    "l1_angle_loss",
    "delta_2_gt",
]
