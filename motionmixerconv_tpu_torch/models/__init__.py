from .encoding import PoseEncoder, harmonic_features
from .mixer_conv import ConvBlock, ConvMixer, ConvMixerBlock, MultiChanSELayer
from .torch_io import load_pt_into, state_dict_from_jax

__all__ = [
    "PoseEncoder",
    "harmonic_features",
    "ConvBlock",
    "ConvMixer",
    "ConvMixerBlock",
    "MultiChanSELayer",
    "load_pt_into",
    "state_dict_from_jax",
]
