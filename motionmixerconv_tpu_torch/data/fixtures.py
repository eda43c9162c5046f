"""Synthetic Human3.6M, AMASS, CMU and AIS corpora in the reference's
exact on-disk formats.

The port's own copy of ``make_h36m_corpus``, ``make_amass_corpus``,
``make_cmu_corpus`` and ``make_ais_corpus`` from
``motionmixerconv_tpu/data/fixtures.py`` (numpy only, same random streams,
so one seed writes the same files from either package). The real corpora
are licensed and not redistributable; these make the CSV expmap, the SMPL
npz and the keypoint JSON pipelines testable end to end.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .constants import AMASS_SPLITS, H36M_ACTIONS


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


def make_amass_corpus(
    data_dir: str,
    splits=None,
    n_subjects: int = 1,
    n_acts: int = 2,
    n_frames: int = 400,
    frame_rate: float = 50.0,
    seed: int = 0,
) -> str:
    """Write {dataset}/{subject}/{act}.npz with 'poses' + 'mocap_framerate'.

    Format parity: dataloader_amass.py:106-121 (52-joint axis-angle poses,
    156 dims, resampled to 25 fps by integer stride). ``splits`` defaults
    to the first directory of each split.
    """
    rng = np.random.RandomState(seed)
    splits = splits if splits is not None else [s[:1] for s in AMASS_SPLITS]
    for split_dirs in splits:
        for ds in split_dirs:
            for subj in range(n_subjects):
                sdir = os.path.join(data_dir, ds, f"subject{subj}")
                os.makedirs(sdir, exist_ok=True)
                for act in range(n_acts):
                    poses = _smooth_walk(rng, n_frames, 156, 0.01)
                    np.savez(
                        os.path.join(sdir, f"act{act}_poses.npz"),
                        poses=poses,
                        mocap_framerate=np.float64(frame_rate),
                    )
    return data_dir


def make_cmu_corpus(
    data_dir: str,
    actions=("basketball", "walking"),
    n_files: int = 2,
    n_frames: int = 300,
    seed: int = 0,
) -> str:
    """Write {action}/{action}_{i}.txt CSV files of 117-dim CMU expmap rows.

    Format parity: load_data_cmu (h36m/utils/data_utils.py:333-394) — files
    are numbered from 1 and live under a per-action directory; each row is
    3 translation dims + 38 joints x 3 expmap dims. ``n_frames`` must be
    >= 152 so the test-split selection (75-frame windows after the 2x
    downsample) is valid.
    """
    rng = np.random.RandomState(seed)
    for action in actions:
        adir = os.path.join(data_dir, action)
        os.makedirs(adir, exist_ok=True)
        for i in range(n_files):
            frames = _smooth_walk(rng, n_frames, 117, 0.02)
            frames[:, 0:3] += rng.randn(3) * 100.0  # translation-ish
            # a few constant columns so the std<1e-4 ignore logic triggers
            frames[:, 36:39] = 0.0
            np.savetxt(
                os.path.join(adir, f"{action}_{i + 1}.txt"),
                frames, delimiter=",", fmt="%.6f",
            )
    return data_dir


def make_ais_corpus(
    data_dir: str,
    actions=("singlePerson_000", "singlePerson_001"),
    n_frames: int = 200,
    fail_frames=(),
    seed: int = 0,
) -> str:
    """Write {action}.json files of per-frame keypoint records.

    Format parity: dataset_ais_xyz.py:27-111 — each frame is
    ``{"person": {"id": 0, "keypoints": [{"pos": [x,y,z], "score": s}, ...]}}``
    with 27 keypoints, of which the first 19 are used. Frames listed in
    ``fail_frames`` get one keypoint with score 0 (detection failure).
    """
    rng = np.random.RandomState(seed)
    os.makedirs(data_dir, exist_ok=True)
    for action in actions:
        # skeleton around a hip at origin, wandering slowly; meters.
        base = rng.randn(27, 3) * 0.3
        base[8] = 0.0  # MidHip
        base[1] = base[8] + np.array([0.0, 0.0, 0.5])  # Neck above hip
        base[9] = base[8] + np.array([0.15, 0.0, 0.0])  # RHip
        base[12] = base[8] + np.array([-0.15, 0.0, 0.0])  # LHip
        drift = _smooth_walk(rng, n_frames, 3, 0.01)
        jitter = _smooth_walk(rng, n_frames, 27 * 3, 0.003).reshape(
            n_frames, 27, 3)
        frames = []
        for t in range(n_frames):
            kps = []
            for k in range(27):
                pos = base[k] + drift[t] + jitter[t, k]
                score = 0.0 if (t in fail_frames and k == 3) else 0.9
                kps.append({"pos": [float(p) for p in pos], "score": score})
            frames.append({"person": {"id": 0, "keypoints": kps}})
        with open(os.path.join(data_dir, f"{action}.json"), "w") as f:
            json.dump(frames, f)
    return data_dir
