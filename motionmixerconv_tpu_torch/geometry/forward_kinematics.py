"""Human3.6M forward kinematics in PyTorch.

Counterpart of ``motionmixerconv_tpu/geometry/forward_kinematics.py``: all
32 joint rotations come from one batched Rodrigues over the (N, J) axis,
then the chain is unrolled over the static topology as batched 3x3
matmuls, so a whole corpus converts in one call on any device. The
CMU skeleton lands with the CMU slice.
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


def fkl(angles: torch.Tensor, skeleton: Optional[Skeleton] = None
        ) -> torch.Tensor:
    """(N, 99) expmap frames -> (N, 32, 3) joint positions in mm.

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
