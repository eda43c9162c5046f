"""Plain reference of the AMASS data set-up (reference
``amass/dataloader_amass.py``, ``utils/ang2joint.py``) and of its 22-joint
test (``amass/train_mixer_amass.py:153-199``).

Nothing here imports the port. It follows the published loader: the npz
archives of each split's dataset directories, each recording resampled to
25 fps by the integer stride ``int(fps // 25)``, its global rotation
(joint 0) zeroed, SMPL forward kinematics from the rest skeleton as 4x4
homogeneous transforms composed down the tree, the joint positions flat
(52 * 3), and every ``seq_len``-frame window at stride ``skip``. Departures:
subjects and files are walked in sorted order (the published loader takes
``os.listdir``'s, which the file system decides); Rodrigues' axis is
normalised by ``sqrt(|r|^2 + 1e-16)`` in place of the published 1e-8
gaussian jitter, so one seed gives one corpus. The rest skeleton is read
from the port's asset as a data file.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

# the dataset directories of each split: train, validation, test
# (dataloader_amass.py:42-46)
SPLITS = [
    ["CMU", "MPI_Limits", "TotalCapture", "Eyes_Japan_Dataset", "KIT",
     "EKUT", "TCD_handMocap", "ACCAD"],
    ["HumanEva", "MPI_HDM05", "SFU", "MPI_mosh"],
    ["BioMotionLab_NTroje"],
]
TARGET_FPS = 25
# joints 4..21 of the 22-joint body, the model's 54 dims
# (dataloader_amass.py:39)
DIM_USED = np.arange(4 * 3, 22 * 3)
BODY_DIMS = 22 * 3
SKELETON = (Path(__file__).resolve().parents[2] / "motionmixerconv_tpu_torch"
            / "assets" / "smpl_skeleton.npz")


def skeleton():
    """(p3d0 (52, 3) rest joint positions float32, parents (52,), -1 at the
    root)."""
    with np.load(SKELETON) as f:
        return f["p3d0"].astype(np.float32)[0], f["parents"].astype(np.int64)


def read_split(data_dir: str, split: int):
    """Each recording of a split as (n, 52, 3) float32 axis-angle poses at
    25 fps, its global rotation zeroed, in the walk's order."""
    out = []
    for ds in SPLITS[split]:
        ds_path = os.path.join(data_dir, ds)
        if not os.path.isdir(ds_path):
            continue
        for sub in sorted(os.listdir(ds_path)):
            sub_path = os.path.join(ds_path, sub)
            if not os.path.isdir(sub_path):
                continue
            for name in sorted(os.listdir(sub_path)):
                if not name.endswith(".npz"):
                    continue
                with np.load(os.path.join(sub_path, name)) as f:
                    if "poses" not in f.files:
                        continue
                    poses, fps = f["poses"], float(f["mocap_framerate"])
                poses = np.array(poses[:: int(fps // TARGET_FPS)], np.float32)
                poses = poses.reshape(poses.shape[0], -1, 3)
                poses[:, 0] = 0.0
                out.append(poses)
    return out


def rodrigues(r: torch.Tensor) -> torch.Tensor:
    """(N, 3) axis-angle -> (N, 3, 3) rotations: cos I + (1 - cos) k k^T +
    sin [k]x (utils/ang2joint.py:62-88)."""
    theta = torch.sqrt((r * r).sum(-1, keepdim=True) + 1e-16)
    k = r / theta
    zero = torch.zeros_like(k[:, 0])
    kx = torch.stack([zero, -k[:, 2], k[:, 1], k[:, 2], zero, -k[:, 0],
                      -k[:, 1], k[:, 0], zero], dim=1).reshape(-1, 3, 3)
    cos, sin = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(r.shape[0], 3, 3)
    return cos * eye + (1.0 - cos) * (k[:, :, None] * k[:, None, :]) + sin * kx


@torch.no_grad()
def forward_kinematics(poses: torch.Tensor) -> torch.Tensor:
    """(N, 52, 3) axis-angle poses -> (N, 52, 3) joint positions: each
    joint's transform is its parent's times [R_i, J_i - J_parent; 0, 1]
    (the root's [R_0, J_0; 0, 1]), its position the translation
    (utils/ang2joint.py:9-56)."""
    p3d0, parents = skeleton()
    rest = torch.as_tensor(p3d0, device=poses.device)
    n, joints = poses.shape[0], poses.shape[1]
    rot = rodrigues(poses.reshape(-1, 3)).reshape(n, joints, 3, 3)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0],
                          device=poses.device).expand(n, 1, 4)

    def homogeneous(r, t):
        return torch.cat([torch.cat([r, t.expand(n, 3)[..., None]], dim=2),
                          bottom], dim=1)

    g = [homogeneous(rot[:, 0], rest[0])]
    for i in range(1, joints):
        p = int(parents[i])
        g.append(g[p] @ homogeneous(rot[:, i], rest[i] - rest[p]))
    return torch.stack([t[:, :3, 3] for t in g], dim=1)


def corpus(data_dir: str, split: int, seq_len: int, skip: int, device):
    """The split's recordings laid end to end as (N, 156) float32 joint
    positions (numpy), and the starts of every ``seq_len``-frame window at
    stride ``skip`` that stays inside one recording."""
    # a recording shorter than a window holds none, and adds no frames
    seqs = [s for s in read_split(data_dir, split) if s.shape[0] >= seq_len]
    starts, off = [], 0
    for s in seqs:
        starts.append(off + np.arange(0, s.shape[0] - seq_len + 1, skip))
        off += s.shape[0]
    poses = torch.as_tensor(np.concatenate(seqs), device=device)
    frames = forward_kinematics(poses).reshape(poses.shape[0], -1)
    return frames.cpu().numpy(), np.concatenate(starts).astype(np.int64)


def amass22(pred: torch.Tensor, full: torch.Tensor, input_n: int,
            output_n: int) -> torch.Tensor:
    """The test's MPJPE in mm per window: the predicted (B, output_n, 54)
    joints written into the 22-joint ground truth of the full (B, L, 156)
    window, the mean joint distance over its 22 joints, x 1000."""
    gt = full[:, input_n: input_n + output_n, :BODY_DIMS]
    out = gt.clone()
    out[:, :, torch.as_tensor(DIM_USED, device=full.device)] = pred
    b = gt.shape[0]
    dist = torch.linalg.norm((gt - out).reshape(b, -1, 3), dim=-1)
    return dist.mean(-1) * 1000.0
