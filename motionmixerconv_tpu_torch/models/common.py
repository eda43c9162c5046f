"""Shared building blocks: torch-default init drawn from a Generator,
the Dropout/BatchNorm/identity regularization switch and LayerNorm.

Counterpart of ``motionmixerconv_tpu/models/common.py``.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def torch_default_init_(module: nn.Module,
                        generator: Optional[torch.Generator] = None) -> None:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for every Linear/Conv weight and
    bias under ``module`` (torch's kaiming-uniform a=sqrt(5) default), drawn
    from ``generator`` so a seed fixes the weights. fan_in is in_features
    for a Linear and in_channels times the kernel's size for a Conv1d or
    Conv2d."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)


class _FlaxRunningVariance:
    """Train mode normalises with the biased batch variance, as torch and
    flax both do, and moves ``running_var`` towards that same biased
    variance (flax ``BatchNorm``); torch's own modules move it towards the
    unbiased one, n/(n-1) larger. ``update_running_stats = False`` keeps the
    running stats still in train mode (the autoregressive rollout's
    forwards). The state_dict keys are torch's. Eval mode is torch's."""

    update_running_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                           self.eps)
        if self.update_running_stats:
            with torch.no_grad():
                dims = [0, *range(2, x.dim())]
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(x.mean(dims), alpha=m)
                self.running_var.mul_(1.0 - m).add_(
                    x.var(dims, unbiased=False), alpha=m)
                self.num_batches_tracked.add_(1)
        return out


class BatchNorm1d(_FlaxRunningVariance, nn.BatchNorm1d):
    """torch's BatchNorm1d over axis 1 of a (B, C, L) input with flax's
    running-variance update (the MlpMixer's ``Regularization(bn_axis=1)``)."""


class BatchNorm2d(_FlaxRunningVariance, nn.BatchNorm2d):
    """torch's BatchNorm2d with flax's running-variance update."""


@contextmanager
def frozen_running_stats(module: nn.Module):
    """Within the block, train-mode BatchNorms under ``module`` normalise
    with batch statistics but leave their running stats as they are."""
    bns = [m for m in module.modules()
           if isinstance(m, _FlaxRunningVariance)]
    for m in bns:
        m.update_running_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_running_stats = True


def Regularization(regularization: float, num_features: int,
                   bn_dims: int = 2) -> nn.Module:
    """regularization > 0 -> Dropout(p); == -1 -> BatchNorm over the
    channel axis 1 (eps 1e-5, momentum 0.1, flax's running-variance
    update): ``BatchNorm2d`` for the ConvMixer's (B, C, T, E) planes,
    ``BatchNorm1d`` (``bn_dims=1``) for the MlpMixer's (B, C, L)
    sequences; otherwise identity.

    Returns the module itself, so a BatchNorm's state_dict keys sit directly
    under the owner's ``reg`` name as in the reference."""
    if regularization > 0.0:
        return nn.Dropout(regularization)
    if regularization == -1.0:
        bn = BatchNorm1d if bn_dims == 1 else BatchNorm2d
        return bn(num_features, eps=1e-5, momentum=0.1)
    return nn.Identity()


def layer_norm(features: int) -> nn.LayerNorm:
    """LayerNorm over the last axis, eps 1e-5."""
    return nn.LayerNorm(features, eps=1e-5)
