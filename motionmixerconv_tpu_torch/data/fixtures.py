"""Synthetic Human3.6M corpus in the reference's exact on-disk format.

The port's own copy of ``make_h36m_corpus`` from
``motionmixerconv_tpu/data/fixtures.py`` (numpy only, same random stream,
so one seed writes the same files from either package). The real corpus is
licensed and not redistributable; this one makes the CSV expmap pipeline
testable end to end. The AMASS, CMU and AIS generators land with their
slices.
"""

from __future__ import annotations

import os

import numpy as np

from .constants import H36M_ACTIONS


def _smooth_walk(rng, n_frames: int, dim: int, scale: float) -> np.ndarray:
    """Smooth random trajectory: integrated, low-pass-filtered noise."""
    steps = rng.randn(n_frames, dim).astype(np.float64) * scale
    kernel = np.ones(9) / 9.0
    for d in range(dim):
        steps[:, d] = np.convolve(steps[:, d], kernel, mode="same")
    return np.cumsum(steps, axis=0)


def make_h36m_corpus(
    data_dir: str,
    subjects=(1, 5, 6, 7, 8, 9, 11),
    actions=None,
    n_frames: int = 400,
    seed: int = 0,
) -> str:
    """Write S{subj}/{action}_{1,2}.txt CSV files of 99-dim expmap rows.

    Format parity: readCSVasFloat (h36m/utils/data_utils.py:197-215) and the
    path layout at dataset_h36m.py:80-81. ``n_frames`` must be >= 334 for the
    SRNN test-window selection to be valid after the 2x downsample.
    """
    rng = np.random.RandomState(seed)
    actions = list(actions) if actions is not None else list(H36M_ACTIONS)
    root = os.path.join(data_dir, "h3.6m", "dataset")
    for subj in subjects:
        sdir = os.path.join(root, f"S{subj}")
        os.makedirs(sdir, exist_ok=True)
        for action in actions:
            for subact in (1, 2):
                frames = _smooth_walk(rng, n_frames, 99, 0.02)
                frames[:, 0:3] += rng.randn(3) * 100.0  # translation-ish
                path = os.path.join(sdir, f"{action}_{subact}.txt")
                np.savetxt(path, frames, delimiter=",", fmt="%.6f")
    return data_dir
