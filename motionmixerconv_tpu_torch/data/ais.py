"""AIS-lab data pipeline: keypoint JSON -> windowed corpus.

Counterpart of ``motionmixerconv_tpu/data/ais.py`` (reference
conv_mixer/datasets/dataset_ais_xyz.py): 19 of 27 keypoints, detection
failures (score == 0) NaN out whole frames and exclude the windows that
overlap them, per-frame canonicalization into a hip-centred orthonormal
basis, then exponential smoothing. Plain numpy on the host, vectorised over
whole actions; the pandas ``ewm(alpha, ignore_na=False).mean()`` is an
explicit decayed numerator/denominator recursion. ``frames_on(device)``
puts the corpus on the training device, as for the H36M and AMASS corpora.

Smoothing leaves a frame NaN only where an action begins with failed
detections. No valid window reads such a frame, and batch padding repeats
the first valid window (``windows.batch_starts``), so it reads none either.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .constants import (
    AIS_LHIP_JOINT,
    AIS_NECK_JOINT,
    AIS_NUM_KPS_USED,
    AIS_RHIP_JOINT,
    AIS_ROOT_JOINT,
)
from .windows import WindowedCorpus


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def canonicalize_frames(coords: np.ndarray) -> np.ndarray:
    """Remove global translation and rotation per frame, batched
    (``remove_global_rot_transl``, dataset_ais_xyz.py:116-144): basis rows
    (right, forward, up) built from the hips and the neck; the output is
    ``basis @ (x - root)`` per joint.

    Args:
        coords: (T, K, 3) raw keypoint positions.
    Returns:
        (T, K, 3) canonicalized positions.
    """
    root = coords[:, AIS_ROOT_JOINT]  # (T, 3)
    up = _normalize(coords[:, AIS_NECK_JOINT] - root)
    right = _normalize(coords[:, AIS_RHIP_JOINT] - coords[:, AIS_LHIP_JOINT])
    forward = _normalize(np.cross(up, right))
    right = _normalize(np.cross(forward, up))
    basis = np.stack([right, forward, up], axis=1)  # (T, 3, 3), rows
    local = coords - root[:, None, :]
    return np.einsum("tij,tkj->tki", basis, local)


def ewm_mean(x: np.ndarray, alpha: float) -> np.ndarray:
    """pandas ``DataFrame.ewm(alpha, adjust=True, ignore_na=False).mean()``
    of a (T, D) array: a NaN entry contributes no observation but still
    ages the weights (ignore_na=False). Columns are vectorised; the
    recursion runs over time."""
    T, D = x.shape
    out = np.full_like(x, np.nan, dtype=np.float64)
    num = np.zeros(D)
    den = np.zeros(D)
    decay = 1.0 - alpha
    for t in range(T):
        num *= decay
        den *= decay
        valid = ~np.isnan(x[t])
        num[valid] += x[t, valid]
        den[valid] += 1.0
        nz = den > 0
        out[t, nz] = num[nz] / den[nz]
    return out.astype(np.float32)


class AISDataset(WindowedCorpus):
    """AIS windowed corpus over one or more actions.

    Args:
        data_dir: directory containing ``{action}.json`` files.
        input_n / output_n: window geometry.
        skip_rate: frame subsampling stride applied at parse time
            (dataset_ais_xyz.py:42).
        actions: list of action names.
        smoothing_alpha: exponential-smoothing coefficient.
        canonicalize: remove global rotation and translation per frame
            (True: the reference's 'local movement' path; False keeps the
            camera-frame coordinates, the 'global movement' variant).
    """

    def __init__(self, data_dir: str, input_n: int, output_n: int,
                 skip_rate: int, actions, smoothing_alpha: float,
                 canonicalize: bool = True):
        self.in_n = input_n
        self.out_n = output_n
        seq_len = input_n + output_n
        dim = AIS_NUM_KPS_USED * 3

        action_frames: list[np.ndarray] = []
        local_starts: list[np.ndarray] = []
        for action in actions:
            with open(os.path.join(data_dir, f"{action}.json")) as f:
                pose_data = json.load(f)

            if len({fr["person"]["id"] for fr in pose_data}) != 1:
                raise ValueError(f"More than one person in action {action}")

            pose_data = pose_data[::skip_rate]
            T = len(pose_data)
            coords = np.full((T, AIS_NUM_KPS_USED, 3), np.nan,
                             dtype=np.float64)
            failed = np.zeros(T, dtype=bool)
            for t, fr in enumerate(pose_data):
                kps = fr["person"]["keypoints"]
                if len(kps) not in (21, 27):
                    raise AssertionError(
                        f"Expected 21 or 27 keypoints, got {len(kps)}")
                used = kps[:AIS_NUM_KPS_USED]
                if any(kp["score"] == 0 for kp in used):
                    failed[t] = True
                    continue
                coords[t] = [kp["pos"] for kp in used]

            ok = ~failed
            if canonicalize and ok.any():
                coords[ok] = canonicalize_frames(coords[ok])
            smoothed = ewm_mean(coords.reshape(T, dim), smoothing_alpha)

            # valid windows: every frame detected; the reference's exclusive
            # upper bound (dataset_ais_xyz.py:74) is kept
            bad_cum = np.concatenate([[0], np.cumsum(failed)])
            starts = np.arange(max(T - seq_len, 0))
            starts = starts[bad_cum[starts + seq_len] == bad_cum[starts]]
            action_frames.append(smoothed)
            local_starts.append(starts.astype(np.int64))

        lengths = np.array([a.shape[0] for a in action_frames])
        offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        window_starts = np.concatenate(
            [off + ls for off, ls in zip(offsets, local_starts)]
        ).astype(np.int64)
        self.actions = list(actions)
        super().__init__(
            frames=np.concatenate(action_frames, axis=0).astype(np.float32),
            window_starts=window_starts, seq_len=seq_len)
