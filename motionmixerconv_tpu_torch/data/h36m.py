"""Human3.6M data pipeline: CSV expmap -> windowed corpus.

Counterpart of ``motionmixerconv_tpu/data/h36m.py`` (reference
h36m/datasets/dataset_h36m.py for xyz, dataset_h36m_ang.py for angle). All
sequences of a split are concatenated and pushed through one batched
forward-kinematics call; windows are then index gathers on the corpus.

Splits: 0 train (S1,6,7,8,9), 1 val (S11), 2 test (S5, SRNN-seeded random
windows: 128 per subaction for xyz via find_indices_256, 4 for angle via
find_indices_srnn). The CSV files are read by the native C++ reader
(``_native``), a split's files at once on its thread pool; a file it
refuses goes to ``np.loadtxt``, which reads it or raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .._native import read_csv_many_native, read_csv_native
from ..geometry import expmap2xyz
from .constants import (
    H36M_ACTIONS,
    H36M_DIM_USED_ANGLE,
    H36M_DIM_USED_XYZ,
    H36M_SUBJECT_SPLITS,
    h36m_dimensions_to_use_xyz,
)
from .windows import WindowedCorpus, find_indices_256, find_indices_srnn

SAMPLE_RATE = 2  # 50 Hz -> 25 Hz (dataset_h36m.py:36)


def _loadtxt(filename: str) -> np.ndarray:
    return np.loadtxt(filename, delimiter=",", dtype=np.float32, ndmin=2)


def read_csv_floats(filename: str) -> np.ndarray:
    """Read a comma-separated float matrix (data_utils.py:197-215) with the
    native reader; a file it refuses goes to ``np.loadtxt``."""
    arr = read_csv_native(filename)
    return arr if arr is not None else _loadtxt(filename)


def _read_corpus(paths: list[str]) -> dict[str, np.ndarray]:
    """Every file of ``paths``, parsed at once on the native thread pool;
    FileNotFoundError for a missing one, ``np.loadtxt`` for one the native
    reader refuses."""
    out = {}
    for p, arr in zip(paths, read_csv_many_native(paths)):
        if arr is None:
            if not os.path.isfile(p):
                raise FileNotFoundError(p)
            arr = _loadtxt(p)
        out[p] = arr
    return out


def _preprocess(seq: np.ndarray) -> np.ndarray:
    seq = np.array(seq[::SAMPLE_RATE], dtype=np.float32)
    seq[:, 0:6] = 0.0  # zero global translation+rotation (dataset_h36m.py:87)
    return seq


class H36MDataset(WindowedCorpus):
    """H3.6M windowed corpus.

    Args:
        data_dir: root containing ``h3.6m/dataset/S{subj}/{action}_{subact}.txt``.
        input_n / output_n: window split (window length = input_n + output_n).
        skip_rate: training-window stride.
        actions: action subset (default: all 15).
        split: 0 train / 1 val / 2 test.
        mode: 'xyz' (FK to 96-dim joint positions) or 'angle' (the raw
            99-dim expmap frames).
    """

    def __init__(self, data_dir: str, input_n: int, output_n: int,
                 skip_rate: int, actions=None, split: int = 0,
                 mode: str = "xyz"):
        if mode not in ("xyz", "angle"):
            raise ValueError(f"mode must be 'xyz' or 'angle', got {mode}")
        self.mode = mode
        self.split = split
        self.in_n = input_n
        self.out_n = output_n
        seq_len = input_n + output_n
        path_to_data = os.path.join(data_dir, "h3.6m", "dataset")
        acts = list(actions) if actions is not None else list(H36M_ACTIONS)
        subs = H36M_SUBJECT_SPLITS[split]

        def path(subj, action, subact):
            return os.path.join(path_to_data, f"S{subj}",
                                f"{action}_{subact}.txt")

        raw_files = _read_corpus([path(subj, action, subact)
                                  for subj in subs for action in acts
                                  for subact in (1, 2)])

        def read(subj, action, subact):
            return _preprocess(raw_files[path(subj, action, subact)])

        sequences: list[np.ndarray] = []
        local_starts: list[np.ndarray] = []  # per-sequence window starts
        for subj in subs:
            for action in acts:
                if split <= 1:
                    for subact in (1, 2):
                        seq = read(subj, action, subact)
                        sequences.append(seq)
                        local_starts.append(np.arange(
                            0, seq.shape[0] - seq_len + 1, skip_rate))
                else:
                    seq1, seq2 = read(subj, action, 1), read(subj, action, 2)
                    finder = find_indices_256 if mode == "xyz" else \
                        find_indices_srnn
                    fs1, fs2 = finder(seq1.shape[0], seq2.shape[0], seq_len,
                                      input_n=input_n)
                    sequences += [seq1, seq2]
                    local_starts += [fs1[:, 0], fs2[:, 0]]

        lengths = np.array([s.shape[0] for s in sequences])
        offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        window_starts = np.concatenate(
            [off + ls for off, ls in zip(offsets, local_starts)]
        ).astype(np.int64)

        raw = np.concatenate(sequences, axis=0)  # (N, 99)
        if mode == "xyz":
            with torch.no_grad():  # one batched FK over the whole corpus
                frames = expmap2xyz(torch.from_numpy(raw)).reshape(
                    raw.shape[0], 96).numpy()
            self.dimensions_to_use = h36m_dimensions_to_use_xyz()
            self.dim_used = H36M_DIM_USED_XYZ
        else:
            frames = raw
            self.dimensions_to_use = H36M_DIM_USED_ANGLE
            self.dim_used = H36M_DIM_USED_ANGLE

        super().__init__(frames=frames, window_starts=window_starts,
                         seq_len=seq_len)
