"""Plain reference of the Human3.6M data set-up (reference
``h36m/datasets/dataset_h36m.py``, ``utils/forward_kinematics.py``): the
50 -> 25 Hz downsample, the zeroed global translation and rotation,
forward kinematics to 32 joints in mm, the used dims, and the windows.

Nothing here imports the port.
"""

from __future__ import annotations

import numpy as np
import torch

SAMPLE_RATE = 2
SRNN_SEED = 1234567890  # the test windows' seed (h36m/utils/data_utils.py:611)

# the 32-joint tree: parents (1-based, 0 the root) and bone offsets in mm
# (reference h36m/utils/forward_kinematics.py:68-135)
PARENT = np.array(
    [0, 1, 2, 3, 4, 5, 1, 7, 8, 9, 10, 1, 12, 13, 14, 15, 13,
     17, 18, 19, 20, 21, 20, 23, 13, 25, 26, 27, 28, 29, 28, 31]) - 1
OFFSET = np.array(
    [0.000000, 0.000000, 0.000000, -132.948591, 0.000000, 0.000000, 0.000000,
     -442.894612, 0.000000, 0.000000, -454.206447, 0.000000, 0.000000, 0.000000,
     162.767078, 0.000000, 0.000000, 74.999437, 132.948826, 0.000000, 0.000000,
     0.000000, -442.894413, 0.000000, 0.000000, -454.206590, 0.000000, 0.000000,
     0.000000, 162.767426, 0.000000, 0.000000, 74.999948, 0.000000, 0.100000,
     0.000000, 0.000000, 233.383263, 0.000000, 0.000000, 257.077681, 0.000000,
     0.000000, 121.134938, 0.000000, 0.000000, 115.002227, 0.000000, 0.000000,
     257.077681, 0.000000, 0.000000, 151.034226, 0.000000, 0.000000, 278.882773,
     0.000000, 0.000000, 251.733451, 0.000000, 0.000000, 0.000000, 0.000000,
     0.000000, 0.000000, 99.999627, 0.000000, 100.000188, 0.000000, 0.000000,
     0.000000, 0.000000, 0.000000, 257.077681, 0.000000, 0.000000, 151.031437,
     0.000000, 0.000000, 278.892924, 0.000000, 0.000000, 251.728680, 0.000000,
     0.000000, 0.000000, 0.000000, 0.000000, 0.000000, 99.999888, 0.000000,
     137.499922, 0.000000, 0.000000, 0.000000, 0.000000]).reshape(-1, 3)

# the 22 joints (66 dims) a model sees: all but the root, the hips' and
# feet's duplicates and the hands' ends (dataset_h36m.py:59-67)
_JOINTS_IGNORED = (0, 1, 6, 11, 16, 20, 23, 24, 28, 31)
DIM_USED_XYZ = np.array([3 * j + k for j in range(32)
                         if j not in _JOINTS_IGNORED for k in range(3)])


# the test's joints re-inserted from their equals (train_mixer_h36m.py:301-306)
_JOINTS_IGNORED_EVAL = (16, 20, 23, 24, 28, 31)
_JOINTS_EQUAL_EVAL = (13, 19, 22, 13, 27, 30)
IGNORE_EVAL = np.array([3 * j + k for k in range(3) for j in _JOINTS_IGNORED_EVAL])
EQUAL_EVAL = np.array([3 * j + k for k in range(3) for j in _JOINTS_EQUAL_EVAL])


def rodrigues(r: torch.Tensor) -> torch.Tensor:
    """(..., 3) exponential map -> (..., 3, 3) rotation, with the
    reference's ``theta + 1e-7`` in the axis's normalisation."""
    theta = torch.linalg.norm(r, dim=-1)
    k = r / (theta[..., None] + 1e-7)
    zero = torch.zeros_like(k[..., 0])
    kx = torch.stack([torch.stack([zero, -k[..., 2], k[..., 1]], dim=-1),
                      torch.stack([k[..., 2], zero, -k[..., 0]], dim=-1),
                      torch.stack([-k[..., 1], k[..., 0], zero], dim=-1)],
                     dim=-2)
    s = torch.sin(theta)[..., None, None]
    c = torch.cos(theta)[..., None, None]
    eye = torch.eye(3, dtype=r.dtype).expand(kx.shape)
    return eye + s * kx + (1.0 - c) * (kx @ kx)


@torch.no_grad()
def forward_kinematics(expmap: np.ndarray) -> np.ndarray:
    """(N, 99) float32 expmap frames -> (N, 96) float32 joint positions in
    mm, on the CPU. A joint whose parent is the root keeps its rest offset
    (the root's rotation is never applied); every other one sits at
    offset @ R_parent + parent. Float32, each product and sum in the order
    written here: the model's harmonic encoder turns a one-ulp difference
    of a position into a different feature, so the frames the reference
    trains on must be the program's to the bit, and they are only as long
    as both compute the same float32 operations."""
    angles = torch.from_numpy(np.ascontiguousarray(expmap, np.float32))
    n = angles.shape[0]
    r_local = rodrigues(angles[:, 3:].reshape(n, 32, 3))
    offset = torch.as_tensor(OFFSET, dtype=torch.float32)
    r_glob = [None] * 32
    pos = [None] * 32
    for i in range(32):
        p = int(PARENT[i])
        if p <= 0:
            r_glob[i] = r_local[:, i]
            pos[i] = offset[i].expand(n, 3)
        else:
            r_glob[i] = r_local[:, i] @ r_glob[p]
            pos[i] = offset[i] @ r_glob[p] + pos[p]
    return torch.stack(pos, dim=1).reshape(n, 96).numpy()


def preprocess(raw: np.ndarray) -> np.ndarray:
    """Raw 50 Hz expmap frames -> 25 Hz with the global translation and
    rotation (dims 0:6) zeroed."""
    seq = np.array(raw[::SAMPLE_RATE], dtype=np.float32)
    seq[:, 0:6] = 0.0
    return seq


def xyz_corpus(raws, seq_len: int, skip: int):
    """The sequences laid end to end as (N, 96) float32 positions, and the
    starts of every ``seq_len``-frame window at stride ``skip`` that stays
    inside one sequence."""
    seqs = [preprocess(r) for r in raws]
    starts, off = [], 0
    for s in seqs:
        starts.append(off + np.arange(0, s.shape[0] - seq_len + 1, skip))
        off += s.shape[0]
    frames = forward_kinematics(np.concatenate(seqs))
    return frames, np.concatenate(starts).astype(np.int64)


def test_starts(n1: int, n2: int, input_n: int, count: int = 128):
    """The starts of the SRNN-seeded test windows of an action's two
    subactions of ``n1`` and ``n2`` frames, ``count`` each
    (h36m/utils/data_utils.py:600-629)."""
    rng = np.random.RandomState(SRNN_SEED)
    s1, s2 = [], []
    for _ in range(count):
        s1.append(rng.randint(16, n1 - 150) + 50 - input_n)
        s2.append(rng.randint(16, n2 - 150) + 50 - input_n)
    return np.array(s1, np.int64), np.array(s2, np.int64)


def test_corpus(raws_by_action, input_n: int):
    """The test split's (N, 96) positions, window starts and group (action)
    of each window, from each action's two raw subactions in order."""
    seqs, starts, groups, off = [], [], [], 0
    for g, (raw1, raw2) in enumerate(raws_by_action):
        a, b = preprocess(raw1), preprocess(raw2)
        f1, f2 = test_starts(a.shape[0], b.shape[0], input_n)
        starts += [off + f1, off + a.shape[0] + f2]
        groups.append(np.full(len(f1) + len(f2), g, np.int64))
        seqs += [a, b]
        off += a.shape[0] + b.shape[0]
    frames = forward_kinematics(np.concatenate(seqs))
    return frames, np.concatenate(starts), np.concatenate(groups)
