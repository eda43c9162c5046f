"""ConvMixer motion-forecasting model (PyTorch).

Counterpart of ``motionmixerconv_tpu/models/mixer_conv.py``. The constructor
takes the flax module's keyword arguments; the public layout is the same,
(B, in_nTP, dimPosIn) -> (B, out_nTP, dimPosOut). Inside, activations are
NCHW (B, conv_nChan, in_nTP, dimPosEmb) and modules carry the reference
torch names, so a reference state_dict loads with ``strict=True``.

Reference quirks kept:
- one MultiChanSELayer instance serves both conv branches; ``se2`` is an
  alias of ``se``, so the state_dict repeats its tensors under ``se2``;
- ``mode_conv='once'`` replaces LN2/conv2 with identity, but the second
  residual still applies the shared SE: x + se(x);
- the decoder applies exact GELU whatever the configured activation;
- conv2's kernel defaults to the clipped transpose of conv1's.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..ops.activations import gelu_exact, get_activation
from .common import (Conv2d, Linear, Regularization, layer_norm,
                     torch_default_init_)
from .encoding import PoseEncoder

Pad = Union[str, Tuple[int, int], None]


def _pad_arg(padding: Pad):
    """None or 'same' -> 'same' (torch puts an even kernel's extra pad on the
    right, as flax SAME does); an int pair is symmetric padding."""
    if padding is None or padding == "same":
        return "same"
    return tuple(padding)


class MultiChanSELayer(nn.Module):
    """SE over the time axis of (B, C, T, E): squeeze by avg/max over (C, E),
    excitation Linear(T -> T//r) -> ReLU -> Linear -> sigmoid, no biases."""

    def __init__(self, in_nTP: int, r: int = 4, use_max_pooling: bool = False,
                 dtype=None):
        super().__init__()
        self.use_max_pooling = use_max_pooling
        self.excitationBlock = nn.Sequential(
            Linear(in_nTP, in_nTP // r, bias=False, compute_dtype=dtype),
            nn.ReLU(),
            Linear(in_nTP // r, in_nTP, bias=False, compute_dtype=dtype),
            nn.Sigmoid(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_max_pooling:
            y = x.amax(dim=(1, 3))
        else:
            y = x.mean(dim=(1, 3))  # (B, T)
        y = self.excitationBlock(y)
        return x * y[:, None, :, None]


class ConvBlock(nn.Module):
    """Conv2d -> activation -> regularization on (B, C, T, E)."""

    def __init__(self, conv_nChan: int, kernel_shape=(1, 3), stride=(1, 1),
                 padding: Pad = "same", activation: str = "gelu",
                 regularization: float = 0.0, dtype=None):
        super().__init__()
        self.conv = Conv2d(conv_nChan, conv_nChan, tuple(kernel_shape),
                           stride=tuple(stride), padding=_pad_arg(padding),
                           compute_dtype=dtype)
        self.act = get_activation(activation)
        self.reg = Regularization(regularization, conv_nChan, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.reg(self.act(self.conv(x)))


class ConvMixerBlock(nn.Module):
    """Two conv branches with a shared SE and residuals on (B, C, T, E)."""

    def __init__(self, dimPosEmb: int, in_nTP: int, conv_nChan: int,
                 conv1_kernel_shape=(1, 3), conv1_stride=None,
                 conv1_padding: Pad = None, mode_conv: str = "twice",
                 conv2_kernel_shape=None, conv2_stride=None,
                 conv2_padding: Pad = None, activation: str = "gelu",
                 regularization: float = 0.0, use_se: bool = True,
                 r_se: int = 4, use_max_pooling: bool = False, dtype=None):
        super().__init__()
        if mode_conv not in ("once", "twice"):
            raise ValueError(
                f"mode_conv {mode_conv} must be one of 'once' or 'twice'")
        self.mode_conv = mode_conv
        self.use_se = use_se
        self.conv1 = ConvBlock(
            conv_nChan, conv1_kernel_shape, conv1_stride or (1, 1),
            conv1_padding if conv1_padding is not None else "same",
            activation, regularization, dtype)
        if use_se:
            self.se = MultiChanSELayer(in_nTP, r_se, use_max_pooling, dtype)
        self.LN1 = layer_norm(dimPosEmb, dtype)
        if mode_conv == "twice":
            k2 = conv2_kernel_shape or (
                min(conv1_kernel_shape[1], in_nTP),
                min(conv1_kernel_shape[0], dimPosEmb),
            )
            self.conv2 = ConvBlock(
                conv_nChan, k2, conv2_stride or (1, 1),
                conv2_padding if conv2_padding is not None else "same",
                activation, regularization, dtype)
            if use_se:
                self.se2 = self.se  # the reference's alias
            self.LN2 = layer_norm(dimPosEmb, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(self.LN1(x))
        if self.use_se:
            y = self.se(y)
        x = x + y
        if self.mode_conv == "twice":
            y = self.conv2(self.LN2(x))
        else:
            y = x  # LN2/conv2 are identity in 'once' mode
        if self.use_se:
            y = self.se(y)
        return x + y


class ConvMixer(nn.Module):
    """(B, in_nTP, dimPosIn) -> (B, out_nTP, dimPosOut).

    ``generator`` seeds the torch-default init; without it the global RNG
    draws. ``dtype`` is the compute dtype, with flax's meaning
    (``models/common.py``): parameters stay float32 and the output is in
    ``dtype``; it does not combine with ``encoder_fused``.
    """

    def __init__(self, num_blocks: int, dimPosIn: int, dimPosEmb: int,
                 dimPosOut: int, in_nTP: int, out_nTP: int,
                 conv_nChan: int = 1, conv1_kernel_shape=(1, 3),
                 conv1_stride=(1, 1), conv1_padding: Pad = None,
                 mode_conv: str = "twice", conv2_kernel_shape=None,
                 conv2_stride=None, conv2_padding: Pad = None,
                 activation: str = "gelu", regularization: float = 0.0,
                 use_se: bool = False, r_se: int = 4,
                 use_max_pooling: bool = False,
                 encoder_n_harmonic_functions: int = 64,
                 encoder_omega0: float = 0.1, encoder_fused: bool = False,
                 encoder_precomputed: bool = False,
                 encoder_harmonic_impl: str = "direct",
                 encoder_embed_dtype: Optional[torch.dtype] = None,
                 dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_blocks = num_blocks
        self.dimPosIn, self.dimPosEmb, self.dimPosOut = dimPosIn, dimPosEmb, dimPosOut
        self.in_nTP, self.out_nTP = in_nTP, out_nTP
        self.conv_nChan = conv_nChan
        self.conv1_kernel_shape = tuple(conv1_kernel_shape)
        self.conv1_stride = conv1_stride
        self.conv1_padding = conv1_padding
        self.mode_conv = mode_conv
        self.conv2_kernel_shape = conv2_kernel_shape
        self.conv2_stride = conv2_stride
        self.conv2_padding = conv2_padding
        self.activation = activation
        self.regularization = regularization
        self.use_se = use_se
        self.r_se = r_se
        self.use_max_pooling = use_max_pooling
        self.encoder_n_harmonic_functions = encoder_n_harmonic_functions
        self.encoder_omega0 = encoder_omega0
        self.encoder_fused = encoder_fused
        self.dtype = dtype
        self.encoder = PoseEncoder(
            dimPosIn, dimPosEmb, conv_nChan,
            n_harmonic_functions=encoder_n_harmonic_functions,
            omega0=encoder_omega0, dtype=dtype, fused=encoder_fused,
            precomputed=encoder_precomputed,
            harmonic_impl=encoder_harmonic_impl,
            embed_dtype=encoder_embed_dtype,
        )
        self.Mixer_Block = nn.ModuleList([
            ConvMixerBlock(
                dimPosEmb, in_nTP, conv_nChan,
                conv1_kernel_shape=conv1_kernel_shape,
                conv1_stride=conv1_stride, conv1_padding=conv1_padding,
                mode_conv=mode_conv, conv2_kernel_shape=conv2_kernel_shape,
                conv2_stride=conv2_stride, conv2_padding=conv2_padding,
                activation=activation, regularization=regularization,
                use_se=use_se, r_se=r_se, use_max_pooling=use_max_pooling,
                dtype=dtype,
            )
            for _ in range(num_blocks)
        ])
        self.LN = layer_norm(dimPosEmb, dtype)
        # time upsample over time-as-channels, then the channel projection
        self.conv_out = Conv2d(in_nTP, out_nTP, 1, compute_dtype=dtype)
        self.project_channels = Conv2d(conv_nChan, 1, 1, compute_dtype=dtype)
        self.fc_out = Linear(dimPosEmb, dimPosOut, compute_dtype=dtype)
        torch_default_init_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.encoder(x).permute(0, 3, 1, 2)  # (B, C, T, E)
        for mb in self.Mixer_Block:
            y = mb(y)
        y = self.LN(y)
        y = self.conv_out(y.transpose(1, 2)).transpose(1, 2)  # (B, C, P, E)
        y = self.project_channels(y)[:, 0]  # (B, P, E)
        y = gelu_exact(y)  # the reference hardcodes GELU here
        return self.fc_out(y)  # (B, P, dimPosOut)
