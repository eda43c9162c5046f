"""Human3.6M data: constants, the synthetic corpus writer, windowed
corpora and their samplers, and the dataset."""

from . import constants, fixtures
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
    "H36MDataset",
    "read_csv_floats",
    "WindowedCorpus",
    "batch_starts",
    "find_indices_256",
    "find_indices_srnn",
    "gather_windows",
]
