from .encoding import ConvEncoder, PoseEncoder, harmonic_features
from .mixer_conv import ConvBlock, ConvMixer, ConvMixerBlock, MultiChanSELayer
from .mixer_mlp import (MixerBlock, MixerBlockChannel, MixerBlockToken,
                        MlpBlock, MlpMixer, SELayer)
from .torch_io import read_weights, state_dict_from_jax

__all__ = [
    "PoseEncoder",
    "ConvEncoder",
    "harmonic_features",
    "ConvBlock",
    "ConvMixer",
    "ConvMixerBlock",
    "MultiChanSELayer",
    "SELayer",
    "MlpBlock",
    "MixerBlock",
    "MixerBlockChannel",
    "MixerBlockToken",
    "MlpMixer",
    "read_weights",
    "state_dict_from_jax",
]
