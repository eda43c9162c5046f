"""Activations and the wrappers of the hand-written CUDA kernels
(``conv_mixer`` and ``conv_mixer_mc``: fused ConvMixer cores; ``harmonic``:
fused harmonic encoder forward and backward; ``mlp_mixer``: fused MlpMixer
forward). Kernels are built by ``_build`` at first use."""

from .activations import get_activation, gelu_exact, mish

__all__ = ["get_activation", "gelu_exact", "mish"]
