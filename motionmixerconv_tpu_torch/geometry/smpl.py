"""SMPL forward kinematics for the AMASS pipeline (PyTorch).

Counterpart of ``motionmixerconv_tpu/geometry/smpl.py``: the reference's
``ang2joint`` (utils/ang2joint.py:9-56) composes 4x4 homogeneous
transforms joint by joint; the joint position it reads out is each
composed transform's translation, so (rotation, translation) pairs are
composed directly, ``(R_p @ R_i, R_p @ t_i + t_p)``, batched over frames.
The rest-pose skeleton is this package's own copy of the reference asset,
``assets/smpl_skeleton.npz``.
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import numpy as np
import torch

from .rotations import rodrigues

_ASSET = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets",
                      "smpl_skeleton.npz")


@functools.lru_cache(maxsize=None)
def load_smpl_skeleton() -> Tuple[np.ndarray, np.ndarray]:
    """(p3d0 (1, 52, 3) rest joint positions float32, parents (52,) int32
    with -1 at the root), the asset amass/dataloader_amass.py:79-84 loads."""
    with np.load(_ASSET) as f:
        return f["p3d0"].astype(np.float32), f["parents"].astype(np.int32)


def ang2joint(p3d0: torch.Tensor, pose: torch.Tensor,
              parents: np.ndarray) -> torch.Tensor:
    """Axis-angle SMPL pose -> joint positions.

    Args:
        p3d0: (B, J, 3) rest-pose joint positions.
        pose: (B, J, 3) axis-angle rotation per joint.
        parents: (J,) parent table, -1 for the root, each parent before
            its children.
    Returns:
        (B, J, 3) posed joint positions:
        t_i = R_parent @ (J_i - J_parent) + t_parent, R_i = R_parent @ R_i_local.
    """
    R_local = rodrigues(pose)  # (B, J, 3, 3)
    n = int(parents.shape[0])
    R = [R_local[:, 0]] + [None] * (n - 1)
    t = [p3d0[:, 0]] + [None] * (n - 1)
    for i in range(1, n):
        p = int(parents[i])
        bone = p3d0[:, i] - p3d0[:, p]
        t[i] = torch.einsum("bij,bj->bi", R[p], bone) + t[p]
        R[i] = R[p] @ R_local[:, i]
    return torch.stack(t, dim=1)
