"""Shared building blocks: torch-default init drawn from a Generator,
the Dropout/BatchNorm/identity regularization switch, LayerNorm, and the
Linear and Conv2d layers with flax's compute ``dtype``.

Counterpart of ``motionmixerconv_tpu/models/common.py``. A compute dtype
(``dtype=torch.bfloat16``) has flax's meaning: parameters stay float32, so
every checkpoint format is unchanged; a Linear or Conv2d casts its input,
weight and bias to the dtype and returns the dtype (flax
``promote_dtype``); LayerNorm and BatchNorm take their statistics in
float32 and return the dtype (flax ``force_float32_reductions``). ``None``
is float32 throughout.

Under a data-parallel mesh (``parallel/``, set on a model by
``use_mesh``) train-mode BatchNorm takes the statistics of the global
batch and Dropout draws the global batch's mask and keeps its own rows, so
that a run on n ranks computes what one rank computes on the whole batch.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def cast(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    """``t`` in the compute ``dtype``; ``dtype=None`` (and ``t=None``)
    leave it as it is."""
    return t if dtype is None or t is None else t.to(dtype)


def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor], dtype,
              axis: int) -> torch.Tensor:
    """``y`` plus ``bias`` along ``axis``, in ``dtype``: flax adds the bias
    after the product, a second rounding in a half-precision dtype."""
    if bias is None:
        return y
    shape = [1] * y.dim()
    shape[axis] = -1
    return y + cast(bias, dtype).reshape(shape)


class Linear(nn.Linear):
    """``nn.Linear`` with flax ``Dense``'s ``compute_dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, compute_dtype=None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return _add_bias(F.linear(cast(x, dt), cast(self.weight, dt)),
                         self.bias, dt, -1)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax ``Conv``'s ``compute_dtype``."""

    def __init__(self, *args, compute_dtype=None, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return _add_bias(self._conv_forward(cast(x, dt), cast(self.weight, dt),
                                            None), self.bias, dt, 1)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` whose statistics are float32 and whose output is in
    ``compute_dtype`` (flax ``LayerNorm(dtype=)``)."""

    def __init__(self, features: int, eps: float = 1e-5, compute_dtype=None):
        super().__init__(features, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return super().forward(x.float()).to(dt)


class Dropout(nn.Dropout):
    """``nn.Dropout``; under a mesh (``mesh`` set by ``use_mesh``) every
    rank draws the mask of the whole global batch, of ``mesh.size`` times
    its rows, from the same seeded generator (on a CUDA device the graph-
    safe one, so a captured step draws anew at each replay) and keeps its
    own rows: the masks do not depend on the number of ranks. The batch is
    axis 0 at every Dropout of the models."""

    mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mesh = self.mesh
        if mesh is None or not self.training or self.p == 0.0:
            return super().forward(x)
        b = x.shape[0]
        keep = torch.empty((b * mesh.size, *x.shape[1:]), device=x.device,
                           dtype=x.dtype).bernoulli_(1.0 - self.p)
        return x * keep[mesh.rank * b:(mesh.rank + 1) * b] / (1.0 - self.p)


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
    forwards). The state_dict keys are torch's. Eval mode is torch's.

    ``compute_dtype``: statistics in float32, output in that dtype. Under a
    mesh (``mesh`` set by ``use_mesh``) train mode takes the global batch's
    statistics, as jit over a sharded batch does, from one all-reduce:
    each rank's per-channel mean in a slot of its own and its sum of
    squared deviations, combined as Chan et al.'s parallel variance (the
    ranks hold equal rows). That keeps the variance as exact as the
    single-device path's, torch's, which a mesh run must match; flax's
    E[x^2] - E[x]^2 loses digits to cancellation where a channel's mean
    is large against its spread. The backward all-reduces the gradient of
    that buffer."""

    update_running_stats = True
    compute_dtype = None
    mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is not None:
            x = x.float()
        if not self.training:
            out = super().forward(x)
        elif self.mesh is None:
            out = F.batch_norm(x, None, None, self.weight, self.bias, True,
                               0.0, self.eps)
            if self.update_running_stats:
                dims = [0, *range(2, x.dim())]
                with torch.no_grad():
                    self._track(x.mean(dims), x.var(dims, unbiased=False))
        else:
            out = self._global_batch_norm(x)
        return out if dt is None else out.to(dt)

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        mesh = self.mesh
        dims = [0, *range(2, x.dim())]
        c = x.shape[1]
        shape = [1, c] + [1] * (x.dim() - 2)
        n = x.numel() // c  # each rank's count
        mean_r = x.mean(dims)
        m2_r = ((x - mean_r.reshape(shape)) ** 2).sum(dims)
        slots = torch.cat([x.new_zeros(mesh.rank * c), mean_r,
                           x.new_zeros((mesh.size - mesh.rank - 1) * c)])
        red = mesh.all_reduce_autograd(torch.cat([slots, m2_r]))
        means = red[:mesh.size * c].reshape(mesh.size, c)
        mean = means.mean(0)
        var = (red[mesh.size * c:] + n * ((means - mean) ** 2).sum(0)) \
            / (n * mesh.size)
        if self.update_running_stats:
            with torch.no_grad():
                self._track(mean, var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) \
            + self.bias.reshape(shape)

    def _track(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
        self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
        self.num_batches_tracked.add_(1)


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


def use_mesh(module: nn.Module, mesh) -> None:
    """Every BatchNorm and Dropout under ``module`` takes the global batch
    of ``mesh`` (a ``parallel.DataMesh``; None: their own rows only)."""
    for m in module.modules():
        if isinstance(m, (_FlaxRunningVariance, Dropout)):
            m.mesh = mesh


def Regularization(regularization: float, num_features: int,
                   bn_dims: int = 2, dtype=None) -> nn.Module:
    """regularization > 0 -> Dropout(p); == -1 -> BatchNorm over the
    channel axis 1 (eps 1e-5, momentum 0.1, flax's running-variance
    update): ``BatchNorm2d`` for the ConvMixer's (B, C, T, E) planes,
    ``BatchNorm1d`` (``bn_dims=1``) for the MlpMixer's (B, C, L)
    sequences; otherwise identity.

    Returns the module itself, so a BatchNorm's state_dict keys sit directly
    under the owner's ``reg`` name as in the reference. ``dtype``: the
    BatchNorm's output dtype (statistics in float32)."""
    if regularization > 0.0:
        return Dropout(regularization)
    if regularization == -1.0:
        bn = BatchNorm1d if bn_dims == 1 else BatchNorm2d
        bn = bn(num_features, eps=1e-5, momentum=0.1)
        bn.compute_dtype = dtype
        return bn
    return nn.Identity()


def layer_norm(features: int, dtype=None) -> LayerNorm:
    """LayerNorm over the last axis, eps 1e-5, output in ``dtype``."""
    return LayerNorm(features, eps=1e-5, compute_dtype=dtype)
