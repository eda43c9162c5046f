"""Human3.6M, AMASS, AIS and CMU data: constants, the synthetic corpus
writers, windowed corpora and their samplers, the datasets, the SRNN-era
normalization utilities and the masking augmentations (``augment``)."""

from . import constants, fixtures
from .ais import AISDataset, canonicalize_frames, ewm_mean
from .amass import AMASSDataset
from .cmu import CMUDataset, define_actions_cmu, load_data_cmu, load_data_cmu_3d
from .h36m import H36MDataset, read_csv_floats
from .normalization import (
    normalization_stats,
    normalize_data,
    revert_output_format,
    unNormalizeData,
)
from .windows import (
    WindowedCorpus,
    batch_starts,
    find_indices_256,
    find_indices_srnn,
    gather_windows,
)

__all__ = [
    "normalization_stats",
    "normalize_data",
    "revert_output_format",
    "unNormalizeData",
    "constants",
    "fixtures",
    "AISDataset",
    "canonicalize_frames",
    "ewm_mean",
    "AMASSDataset",
    "H36MDataset",
    "read_csv_floats",
    "WindowedCorpus",
    "batch_starts",
    "find_indices_256",
    "find_indices_srnn",
    "gather_windows",
    "CMUDataset",
    "define_actions_cmu",
    "load_data_cmu",
    "load_data_cmu_3d",
]
