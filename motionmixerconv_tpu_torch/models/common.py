"""Shared building blocks: torch-default init drawn from a Generator,
the Dropout/BatchNorm/identity regularization switch and LayerNorm.

Counterpart of ``motionmixerconv_tpu/models/common.py``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def torch_default_init_(module: nn.Module,
                        generator: Optional[torch.Generator] = None) -> None:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for every Linear/Conv2d weight and
    bias under ``module`` (torch's kaiming-uniform a=sqrt(5) default), drawn
    from ``generator`` so a seed fixes the weights. fan_in is in_features
    for a Linear and in_channels * kh * kw for a Conv2d."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)


def Regularization(regularization: float, num_features: int) -> nn.Module:
    """regularization > 0 -> Dropout(p); == -1 -> BatchNorm2d over the
    conv-channel axis (eps 1e-5, momentum 0.1); otherwise identity.

    Returns the module itself, so a BatchNorm's state_dict keys sit directly
    under the owner's ``reg`` name as in the reference."""
    if regularization > 0.0:
        return nn.Dropout(regularization)
    if regularization == -1.0:
        return nn.BatchNorm2d(num_features, eps=1e-5, momentum=0.1)
    return nn.Identity()


def layer_norm(features: int) -> nn.LayerNorm:
    """LayerNorm over the last axis, eps 1e-5."""
    return nn.LayerNorm(features, eps=1e-5)
