"""Human3.6M, AMASS and AIS data: constants, the synthetic corpus writers,
windowed corpora and their samplers, and the datasets."""

from . import constants, fixtures
from .ais import AISDataset, canonicalize_frames, ewm_mean
from .amass import AMASSDataset
from .h36m import H36MDataset, read_csv_floats
from .windows import (
    WindowedCorpus,
    batch_starts,
    find_indices_256,
    find_indices_srnn,
    gather_windows,
)

__all__ = [
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
]
