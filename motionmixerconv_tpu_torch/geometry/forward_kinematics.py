"""Human3.6M and CMU-mocap forward kinematics in PyTorch.

Counterpart of ``motionmixerconv_tpu/geometry/forward_kinematics.py``: all
joint rotations come from one batched Rodrigues over the (N, J) axis,
then the chain is unrolled over the static topology as batched 3x3
matmuls, so a whole corpus converts in one call on any device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from .rotations import expmap2rotmat


class Skeleton(NamedTuple):
    """Static kinematic tree: parent (J,) with -1 at the root, and the
    (J, 3) bone offsets in mm."""

    parent: np.ndarray
    offset: np.ndarray

    @property
    def num_joints(self) -> int:
        return int(self.parent.shape[0])


# H3.6M 32-joint tree (reference h36m/utils/forward_kinematics.py:68-135)
_H36M_PARENT = np.array(
    [0, 1, 2, 3, 4, 5, 1, 7, 8, 9, 10, 1, 12, 13, 14, 15, 13,
     17, 18, 19, 20, 21, 20, 23, 13, 25, 26, 27, 28, 29, 28, 31]
) - 1

_H36M_OFFSET = np.array(
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
     137.499922, 0.000000, 0.000000, 0.000000, 0.000000]
).reshape(-1, 3)


@functools.lru_cache(maxsize=None)
def h36m_skeleton() -> Skeleton:
    """The standard 32-joint H3.6M skeleton."""
    return Skeleton(parent=_H36M_PARENT, offset=_H36M_OFFSET)


# CMU-mocap 38-joint tree (reference h36m/utils/forward_kinematics.py:138-216
# ``_some_variables_cmu``; the reference defines it but never trains on CMU)
_CMU_PARENT = np.array(
    [0, 1, 2, 3, 4, 5, 6, 1, 8, 9, 10, 11, 12, 1, 14, 15, 16, 17, 18, 19, 16,
     21, 22, 23, 24, 25, 26, 24, 28, 16, 30, 31, 32, 33, 34, 35, 33, 37]
) - 1

_CMU_OFFSET = 70 * np.array(
    [0, 0, 0, 0, 0, 0, 1.65674, -1.80282, 0.62477, 2.59720, -7.13576, 0,
     2.49236, -6.84770, 0, 0.19704, -0.54136, 2.14581, 0, 0, 1.11249, 0, 0, 0,
     -1.61070, -1.80282, 0.62476, -2.59502, -7.12977, 0, -2.46780, -6.78024,
     0, -0.23024, -0.63258, 2.13368, 0, 0, 1.11569, 0, 0, 0, 0.01961, 2.05450,
     -0.14112, 0.01021, 2.06436, -0.05921, 0, 0, 0, 0.00713, 1.56711, 0.14968,
     0.03429, 1.56041, -0.10006, 0.01305, 1.62560, -0.05265, 0, 0, 0, 3.54205,
     0.90436, -0.17364, 4.86513, 0, 0, 3.35554, 0, 0, 0, 0, 0, 0.66117, 0, 0,
     0.53306, 0, 0, 0, 0, 0, 0.54120, 0, 0.54120, 0, 0, 0, -3.49802, 0.75994,
     -0.32616, -5.02649, 0, 0, -3.36431, 0, 0, 0, 0, 0, -0.73041, 0, 0,
     -0.58887, 0, 0, 0, 0, 0, -0.59786, 0, 0.59786]
).reshape(-1, 3)


@functools.lru_cache(maxsize=None)
def cmu_skeleton() -> Skeleton:
    """The 38-joint CMU-mocap skeleton (117-dim expmap frames)."""
    return Skeleton(parent=_CMU_PARENT, offset=_CMU_OFFSET)


def fkl(angles: torch.Tensor, skeleton: Optional[Skeleton] = None
        ) -> torch.Tensor:
    """(N, 3 + 3J) expmap frames -> (N, J, 3) joint positions in mm, J = 32
    for the default H3.6M skeleton (99-dim frames), 38 for
    ``cmu_skeleton()`` (117-dim frames).

    Parity with reference ``fkl_torch`` (forward_kinematics.py:219-241):
    joints whose parent is the root keep their rest offset (the root
    rotation, dims 3:6, is never applied), and each child sits at
    ``offset @ R_parent_global + parent_position``.
    """
    skel = skeleton or h36m_skeleton()
    n_joints = skel.num_joints
    n = angles.shape[0]
    r_local = expmap2rotmat(angles[:, 3:].reshape(n, n_joints, 3))
    offset = torch.as_tensor(skel.offset, dtype=angles.dtype,
                             device=angles.device)
    r_glob: list = [None] * n_joints
    pos: list = [None] * n_joints
    for i in range(n_joints):
        p = int(skel.parent[i])
        if p <= 0:
            r_glob[i] = r_local[:, i]
            pos[i] = offset[i].expand(n, 3)
        else:
            r_glob[i] = r_local[:, i] @ r_glob[p]
            pos[i] = offset[i] @ r_glob[p] + pos[p]
    return torch.stack(pos, dim=1)


def expmap2xyz(expmap: torch.Tensor) -> torch.Tensor:
    """(N, 99) H3.6M expmap frames -> (N, 32, 3) xyz joint positions
    (reference ``expmap2xyz_torch``, data_utils.py:577-585)."""
    return fkl(expmap)
