"""Activation functions with exact torch-reference numerics.

Counterpart of ``motionmixerconv_tpu/ops/activations.py``: exact-erf GELU
(torch ``nn.GELU()``) and mish, resolved by name.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch ``nn.GELU()``."""
    return F.gelu(x, approximate="none")


def mish(x: torch.Tensor) -> torch.Tensor:
    """Mish: x * tanh(softplus(x)), with the overflow-free softplus
    log1p(exp(-|x|)) + max(x, 0) (the form the CUDA kernel uses too)."""
    return x * torch.tanh(torch.log1p(torch.exp(-x.abs())) + x.clamp_min(0.0))


_ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "gelu": gelu_exact,
    "mish": mish,
}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Resolve an activation by name ('gelu' | 'mish'); ValueError otherwise."""
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"Unknown activation function type: {name}") from None
