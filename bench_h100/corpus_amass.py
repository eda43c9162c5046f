"""The benchmark's seeded AMASS corpus: SMPL pose archives in the layout
of the AMASS release, made from ``--seed`` alone.

Each recording is ``{dataset}/subject{s}/rec{r}_poses.npz`` holding
``poses`` (n, 156) float32, the 52 joints' axis-angle rotations, and
``mocap_framerate``, as the AMASS archives hold them. A rotation is an
integrated, low-pass-filtered random walk per dimension (the H36M corpus's
``_smooth_walk``, ``corpus.py``), drawn from a NumPy ``SeedSequence`` of
(seed, split, dataset, subject, recording), so that seeds beyond 32 bits
work. The dataset directories of a split are the first of the AMASS
splits' own names (``AMASS_SPLITS``), as many as the layout asks for.
"""

from __future__ import annotations

import os

import numpy as np

from .reference.amass import SPLITS

POSE_DIMS = 52 * 3
STEP_SCALE = 0.02  # radians a frame before the filter
SMOOTH = 9  # the low-pass filter's width, in frames


def recording(seed: int, split: int, dataset: int, subject: int,
              rec: int, n_frames: int) -> np.ndarray:
    """(n_frames, 156) float32 axis-angle poses of one recording."""
    rng = np.random.default_rng([int(seed), split, dataset, subject, rec])
    start = rng.uniform(-0.5, 0.5, POSE_DIMS)
    steps = rng.standard_normal((n_frames, POSE_DIMS)) * STEP_SCALE
    half = SMOOTH // 2
    padded = np.concatenate([np.zeros((half + 1, POSE_DIMS)), steps,
                             np.zeros((half, POSE_DIMS))])
    c = np.cumsum(padded, axis=0)
    smooth = (c[SMOOTH:] - c[:-SMOOTH]) / SMOOTH  # 'same' moving average
    return (start + np.cumsum(smooth, axis=0)).astype(np.float32)


def layout(corpus: dict):
    """(split, dataset index, directory name, subjects, recordings) of
    every dataset directory the layout ``corpus`` asks for."""
    out = []
    for split in range(3):
        for d in range(corpus["datasets"][split]):
            out.append((split, d, SPLITS[split][d], corpus["subjects"][split],
                        corpus["recordings"][split]))
    return out


def write(data_dir: str, seed: int, corpus: dict, n_frames: int) -> str:
    """Write every recording of the layout ``corpus`` ({"datasets",
    "subjects", "recordings": one count per split; "framerate"}) under
    ``data_dir``, ``n_frames`` raw frames each."""
    for split, d, name, n_subjects, n_recs in layout(corpus):
        for s in range(n_subjects):
            sdir = os.path.join(data_dir, name, f"subject{s}")
            os.makedirs(sdir, exist_ok=True)
            for r in range(n_recs):
                np.savez(os.path.join(sdir, f"rec{r}_poses.npz"),
                         poses=recording(seed, split, d, s, r, n_frames),
                         mocap_framerate=np.float64(corpus["framerate"]))
    return data_dir
