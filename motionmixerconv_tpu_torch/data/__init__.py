"""Human3.6M and AMASS data: constants, the synthetic corpus writers,
windowed corpora and their samplers, and the datasets."""

from . import constants, fixtures
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
    "AMASSDataset",
    "H36MDataset",
    "read_csv_floats",
    "WindowedCorpus",
    "batch_starts",
    "find_indices_256",
    "find_indices_srnn",
    "gather_windows",
]
