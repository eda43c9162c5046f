"""Losses and evaluation metrics in PyTorch.

Counterpart of ``motionmixerconv_tpu/metrics/metrics.py`` (reference
h36m/utils/utils_mixer.py). The reference's 299-threshold PCK loop becomes
a closed-form lookup and its sequential delta decode a ``cumsum``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.rotations import expmap2rotmat, rotmat2euler


def mpjpe_error(batch_pred: torch.Tensor, batch_gt: torch.Tensor
                ) -> torch.Tensor:
    """Mean per-joint position error: mean L2 over all (..., 3) joint
    coordinates (utils_mixer.py:48-53)."""
    diff = (batch_gt - batch_pred).reshape(-1, 3)
    return torch.linalg.norm(diff, dim=-1).mean()


def pck(predictions: torch.Tensor, targets: torch.Tensor, thresh
        ) -> torch.Tensor:
    """Percentage of correct keypoints within ``thresh`` (utils_mixer.py:
    20-34); a (T,) vector of thresholds gives a (T,) result."""
    dist = torch.sqrt(torch.sum((predictions - targets) ** 2, dim=-1))
    thresh = torch.as_tensor(thresh, dtype=dist.dtype, device=dist.device)
    if thresh.dim() == 0:
        return (dist <= thresh).float().mean()
    ok = dist[None, ...] <= thresh.reshape((-1,) + (1,) * dist.dim())
    return ok.float().mean(dim=tuple(range(1, dist.dim() + 1)))


# The reference integrates mean(1[d <= t]) over the 299-point grid with
# trapz (utils_mixer.py:36-45). The integrand is linear in the per-distance
# indicators, so AUC == mean_d W[k(d)] / 0.299 with W[k] = sum_{i>=k} w_i
# (the trapz weights) and k(d) = #(grid < d). The grid is numpy's float32
# arange, the same values as the JAX package's.
_AUC_GRID = np.arange(0.001, 0.3, 0.001, dtype=np.float32)  # (299,)
_AUC_W = np.full(299, 0.001)
_AUC_W[0] = _AUC_W[-1] = 0.0005
_AUC_SUFFIX = np.concatenate(
    [np.cumsum(_AUC_W[::-1])[::-1], [0.0]]).astype(np.float32)  # (300,)


def auc_pck_from_dist(dist: torch.Tensor, dim=None) -> torch.Tensor:
    """AUC-PCK from joint distances, the exact trapz value. ``dim=None``
    averages over every distance; a tuple over those dims only (e.g.
    per-sample curves). A NaN distance lands in the terminal bucket (zero
    credit), as the JAX package's broadcast count puts it."""
    grid = torch.as_tensor(_AUC_GRID, device=dist.device)
    suffix = torch.as_tensor(_AUC_SUFFIX, device=dist.device)
    k = torch.searchsorted(grid, dist.contiguous(), side="left")
    k = torch.where(torch.isnan(dist), torch.full_like(k, 299), k)
    vals = suffix[k]
    out = vals.mean() if dim is None else vals.mean(dim=dim)
    return out / 0.299


def auc_pck_metric(predictions: torch.Tensor, targets: torch.Tensor
                   ) -> torch.Tensor:
    """AUC of the PCK curve over thresholds 0.001..0.3, step 0.001
    (utils_mixer.py:36-45)."""
    dist = torch.sqrt(torch.sum((predictions - targets) ** 2, dim=-1))
    return auc_pck_from_dist(dist)


def joint_angle_error(ang_pred: torch.Tensor, ang_gt: torch.Tensor
                      ) -> torch.Tensor:
    """Mean L2 error in angle space (utils_mixer.py:55-57)."""
    return torch.linalg.norm(ang_gt - ang_pred, dim=-1).mean()


def euler_error(ang_pred: torch.Tensor, ang_gt: torch.Tensor) -> torch.Tensor:
    """Euler-angle error through expmap -> rotmat -> euler on both sides,
    then the mean L2 over per-frame euler vectors (utils_mixer.py:59-73)."""
    dim_full_len = ang_gt.shape[2]
    pred_eul = rotmat2euler(expmap2rotmat(ang_pred.reshape(-1, 3)))
    targ_eul = rotmat2euler(expmap2rotmat(ang_gt.reshape(-1, 3)))
    diff = (pred_eul - targ_eul).reshape(-1, dim_full_len)
    return torch.linalg.norm(diff, dim=1).mean()


def l1_angle_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Angle-path training loss, ``mean(sum(abs(pred - gt), dim=2))``
    (train_mixer_h36m.py:185)."""
    return torch.sum(torch.abs(pred - gt), dim=2).mean()


def delta_2_gt(prediction: torch.Tensor, last_timestep: torch.Tensor
               ) -> torch.Tensor:
    """Decode velocity predictions into absolute poses:
    ``out[t] = last + sum(pred[0..t])`` (utils_mixer.py:165-175)."""
    return last_timestep[:, None, :] + torch.cumsum(prediction, dim=1)


def criterion_cos(input_f: torch.Tensor, target_f: torch.Tensor
                  ) -> torch.Tensor:
    """Cosine similarity over dim 2 (utils_mixer.py:10-13)."""
    return _cosine(input_f, target_f, dim=2)


def criterion_cos2(input_f: torch.Tensor, target_f: torch.Tensor
                   ) -> torch.Tensor:
    """Cosine similarity over dim 1 (utils_mixer.py:15-17)."""
    return _cosine(input_f, target_f, dim=1)


def _cosine(a: torch.Tensor, b: torch.Tensor, dim: int, eps: float = 1e-6
            ) -> torch.Tensor:
    # each norm clamped at eps, as torch.nn.CosineSimilarity does
    na = torch.clamp(torch.linalg.norm(a, dim=dim), min=eps)
    nb = torch.clamp(torch.linalg.norm(b, dim=dim), min=eps)
    return torch.sum(a * b, dim=dim) / (na * nb)
