"""AMASS data pipeline: SMPL npz archives -> windowed corpus.

Counterpart of ``motionmixerconv_tpu/data/amass.py`` (reference
amass/dataloader_amass.py): walks ``{dataset}/{subject}/{act}.npz`` per
split directory, resamples each recording to 25 fps by an integer stride,
zeroes the global rotation, and runs SMPL forward kinematics. The reference
runs ``ang2joint`` file by file; here every resampled frame of the split
goes through one batched FK call.

Stored frames are the flat (52 * 3,) joint positions; the trainer selects
``AMASS_DIM_USED`` (joints 4..21, 54 dims). The walk and the FK are the
``data.read`` and ``data.fk`` spans of ``profiling``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..geometry import ang2joint, load_smpl_skeleton
from ..profiling import span
from .constants import AMASS_SPLITS, AMASS_TARGET_FPS
from .windows import WindowedCorpus


class AMASSDataset(WindowedCorpus):
    """AMASS windowed corpus.

    Args:
        data_dir: root holding the AMASS sub-dataset directories.
        input_n / output_n / skip_rate: window geometry.
        actions: ignored, as by the reference (dataloader_amass.py:20).
        split: 0 train / 1 val / 2 test (directory lists in AMASS_SPLITS).
    """

    def __init__(self, data_dir: str, input_n: int, output_n: int,
                 skip_rate: int, actions=None, split: int = 0):
        del actions
        self.split = split
        self.in_n = input_n
        self.out_n = output_n
        seq_len = input_n + output_n

        sequences = []  # resampled (n, 52, 3) poses per file
        self.keys = []
        with span("data.read"):
            for ds in AMASS_SPLITS[split]:
                ds_path = os.path.join(data_dir, ds)
                if not os.path.isdir(ds_path):
                    continue
                for sub in sorted(os.listdir(ds_path)):
                    sub_path = os.path.join(ds_path, sub)
                    if not os.path.isdir(sub_path):
                        continue
                    for act in sorted(os.listdir(sub_path)):
                        if not act.endswith(".npz"):
                            continue
                        with np.load(os.path.join(sub_path, act)) as pose_all:
                            if "poses" not in pose_all.files:
                                continue
                            poses = pose_all["poses"]
                            frame_rate = float(pose_all["mocap_framerate"])
                        sample_rate = int(frame_rate // AMASS_TARGET_FPS)
                        poses = poses[::sample_rate].astype(np.float32)
                        fn = poses.shape[0]
                        if fn < seq_len:
                            continue
                        poses = poses.reshape(fn, -1, 3)
                        poses[:, 0] = 0.0  # remove the global rotation
                        sequences.append(poses)
                        self.keys.append((ds, sub, act))
        if not sequences:
            raise FileNotFoundError(f"no AMASS npz files under {data_dir}")

        lengths = np.array([s.shape[0] for s in sequences])
        offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        window_starts = np.concatenate(
            [off + np.arange(0, n - seq_len + 1, skip_rate)
             for off, n in zip(offsets, lengths)]).astype(np.int64)

        all_poses = torch.from_numpy(np.concatenate(sequences))  # (N, 52, 3)
        p3d0, parents = load_smpl_skeleton()
        rest = torch.from_numpy(p3d0).expand(all_poses.shape[0], -1, -1)
        # one batched FK over the whole split
        with span("data.fk"), torch.no_grad():
            xyz = ang2joint(rest, all_poses, parents)
        frames = xyz.reshape(all_poses.shape[0], -1).numpy()  # (N, 156)
        super().__init__(frames=frames, window_starts=window_starts,
                         seq_len=seq_len)

    def __getitem__(self, item: int) -> np.ndarray:
        """(seq_len, 52, 3), the reference item's shape."""
        return super().__getitem__(item).reshape(self.seq_len, -1, 3)
