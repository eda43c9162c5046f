"""MLP-Mixer motion-forecasting model (PyTorch).

Counterpart of ``motionmixerconv_tpu/models/mixer_mlp.py``. The constructor
takes the flax module's keyword arguments; the public layout is the same,
(B, seq_len, input_size) -> (B, pred_len, num_classes), with activations
(B, seq_len, hidden_dim) between the blocks. Modules carry the reference
torch names and layouts, so a reference state_dict loads with
``strict=True``:

- ``conv`` is the reference's ``Conv2d(1, hidden, (1, input_size))`` pose
  embedding, weight (H, 1, 1, D). It spans the whole feature axis, so the
  forward applies it as the per-frame Linear it is;
- ``conv_out`` is the reference's ``Conv1d(seq_len, pred_len, 1)`` time
  upsample over time-as-channels, weight (P, T, 1), applied as a matmul;
- the SE weights are ``se.excitation.{0,2}``.

Reference quirks kept: one SELayer instance serves both branches of a
block; the channel-only block opens with ``x + se(x)``; the token-only
block returns ``x + 2 * se(token_mix(LN(x)))``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.activations import get_activation
from .common import Linear, Regularization, cast, layer_norm, torch_default_init_


class SELayer(nn.Module):
    """Squeeze-and-Excitation over the time axis of (B, S, H): squeeze by
    mean or max over H, excitation Linear(S -> S//r) -> ReLU -> Linear ->
    sigmoid, no biases."""

    def __init__(self, c: int, r: int = 4, use_max_pooling: bool = False,
                 dtype=None):
        super().__init__()
        self.use_max_pooling = use_max_pooling
        self.excitation = nn.Sequential(
            Linear(c, c // r, bias=False, compute_dtype=dtype),
            nn.ReLU(),
            Linear(c // r, c, bias=False, compute_dtype=dtype),
            nn.Sigmoid(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.amax(dim=-1) if self.use_max_pooling else x.mean(dim=-1)
        return x * self.excitation(y)[..., None]


class MlpBlock(nn.Module):
    """fc1 -> activation -> regularization -> fc2 -> regularization over the
    last axis; a BatchNorm normalises axis 1 (``bn_dim`` channels)."""

    def __init__(self, hidden_dim: int, input_dim: int, bn_dim: int,
                 activation: str = "gelu", regularization: float = 0.0,
                 dtype=None):
        super().__init__()
        self.fc1 = Linear(input_dim, hidden_dim, compute_dtype=dtype)
        self.fc2 = Linear(hidden_dim, input_dim, compute_dtype=dtype)
        self.act = get_activation(activation)
        self.reg1 = Regularization(regularization, bn_dim, 1, dtype)
        self.reg2 = Regularization(regularization, bn_dim, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.reg2(self.fc2(self.reg1(self.act(self.fc1(x)))))


class MixerBlock(nn.Module):
    """Token mixing then channel mixing, each with the shared SE and a
    residual, on (B, seq_len, hidden_dim)."""

    def __init__(self, tokens_mlp_dim: int, channels_mlp_dim: int,
                 seq_len: int, hidden_dim: int, activation: str = "gelu",
                 regularization: float = 0.0, r_se: int = 4,
                 use_max_pooling: bool = False, use_se: bool = True,
                 dtype=None):
        super().__init__()
        self.use_se = use_se
        self.mlp_block_token_mixing = MlpBlock(
            tokens_mlp_dim, seq_len, hidden_dim, activation, regularization,
            dtype)
        self.mlp_block_channel_mixing = MlpBlock(
            channels_mlp_dim, hidden_dim, seq_len, activation, regularization,
            dtype)
        if use_se:
            self.se = SELayer(seq_len, r_se, use_max_pooling, dtype)
        self.LN1 = layer_norm(hidden_dim, dtype)
        self.LN2 = layer_norm(hidden_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.mlp_block_token_mixing(self.LN1(x).transpose(1, 2))
        y = y.transpose(1, 2)
        if self.use_se:
            y = self.se(y)
        x = x + y
        y = self.mlp_block_channel_mixing(self.LN2(x))
        if self.use_se:
            y = self.se(y)
        return x + y


class MixerBlockChannel(nn.Module):
    """Channel mixing only, with the reference's leading ``x + se(x)``."""

    def __init__(self, channels_mlp_dim: int, seq_len: int, hidden_dim: int,
                 activation: str = "gelu", regularization: float = 0.0,
                 r_se: int = 4, use_max_pooling: bool = False,
                 use_se: bool = True, dtype=None):
        super().__init__()
        self.use_se = use_se
        self.mlp_block_channel_mixing = MlpBlock(
            channels_mlp_dim, hidden_dim, seq_len, activation, regularization,
            dtype)
        if use_se:
            self.se = SELayer(seq_len, r_se, use_max_pooling, dtype)
        self.LN2 = layer_norm(hidden_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + (self.se(x) if self.use_se else x)
        y = self.mlp_block_channel_mixing(self.LN2(x))
        if self.use_se:
            y = self.se(y)
        return x + y


class MixerBlockToken(nn.Module):
    """Token mixing only, with the reference's double residual:
    ``(x + y) + y`` = x + 2 * se(token_mix(LN(x)))."""

    def __init__(self, tokens_mlp_dim: int, seq_len: int, hidden_dim: int,
                 activation: str = "gelu", regularization: float = 0.0,
                 r_se: int = 4, use_max_pooling: bool = False,
                 use_se: bool = True, dtype=None):
        super().__init__()
        self.use_se = use_se
        self.mlp_block_token_mixing = MlpBlock(
            tokens_mlp_dim, seq_len, hidden_dim, activation, regularization,
            dtype)
        if use_se:
            self.se = SELayer(seq_len, r_se, use_max_pooling, dtype)
        self.LN1 = layer_norm(hidden_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.mlp_block_token_mixing(self.LN1(x).transpose(1, 2))
        y = y.transpose(1, 2)
        if self.use_se:
            y = self.se(y)
        x = x + y
        return x + y


class MlpMixer(nn.Module):
    """(B, seq_len, input_size) -> (B, pred_len, num_classes).

    ``mlp_block_type`` selects the block: 'channel_only', 'token_only', or
    anything else for the normal block, as in the flax module.
    ``generator`` seeds the torch-default init; without it the global RNG
    draws. ``dtype`` is the compute dtype, with flax's meaning
    (``models/common.py``): parameters stay float32 and the output is in
    ``dtype``.
    """

    def __init__(self, num_classes: int, num_blocks: int, hidden_dim: int,
                 tokens_mlp_dim: int, channels_mlp_dim: int, seq_len: int,
                 pred_len: int, activation: str = "gelu",
                 mlp_block_type: str = "normal", regularization: float = 0.0,
                 input_size: int = 51, r_se: int = 4,
                 use_max_pooling: bool = False, use_se: bool = False,
                 dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.num_classes, self.num_blocks = num_classes, num_blocks
        self.hidden_dim = hidden_dim
        self.tokens_mlp_dim = tokens_mlp_dim
        self.channels_mlp_dim = channels_mlp_dim
        self.seq_len, self.pred_len = seq_len, pred_len
        self.activation = activation
        self.mlp_block_type = mlp_block_type
        self.regularization = regularization
        self.input_size = input_size
        self.r_se = r_se
        self.use_max_pooling = use_max_pooling
        self.use_se = use_se
        self.conv = nn.Conv2d(1, hidden_dim, (1, input_size))
        common = dict(seq_len=seq_len, hidden_dim=hidden_dim,
                      activation=activation, regularization=regularization,
                      r_se=r_se, use_max_pooling=use_max_pooling,
                      use_se=use_se, dtype=dtype)
        if mlp_block_type == "channel_only":
            blocks = [MixerBlockChannel(channels_mlp_dim, **common)
                      for _ in range(num_blocks)]
        elif mlp_block_type == "token_only":
            blocks = [MixerBlockToken(tokens_mlp_dim, **common)
                      for _ in range(num_blocks)]
        else:
            blocks = [MixerBlock(tokens_mlp_dim, channels_mlp_dim, **common)
                      for _ in range(num_blocks)]
        self.Mixer_Block = nn.ModuleList(blocks)
        self.LN = layer_norm(hidden_dim, dtype)
        self.fc_out = Linear(hidden_dim, num_classes, compute_dtype=dtype)
        self.conv_out = nn.Conv1d(seq_len, pred_len, 1)
        torch_default_init_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        # the (1, D) Conv2d over the whole feature axis: a per-frame Linear
        y = F.linear(cast(x, dt), cast(self.conv.weight[:, 0, 0, :], dt),
                     cast(self.conv.bias, dt))
        for mb in self.Mixer_Block:
            y = mb(y)
        y = self.LN(y)
        # Conv1d(T, P, 1) over time-as-channels: (P, T) @ (B, T, H)
        y = (cast(self.conv_out.weight[:, :, 0], dt) @ y
             + cast(self.conv_out.bias, dt)[:, None])
        return self.fc_out(y)
