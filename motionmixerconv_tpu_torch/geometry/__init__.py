"""Rotations, Human3.6M forward kinematics and SMPL forward kinematics
(PyTorch)."""

from .forward_kinematics import expmap2xyz, fkl, h36m_skeleton
from .rotations import (
    expmap2quat,
    expmap2rotmat,
    quat2expmap,
    quat_norm_valid,
    rodrigues,
    rotmat2euler,
    rotmat2expmap,
    rotmat2quat,
)
from .smpl import ang2joint, load_smpl_skeleton

__all__ = [
    "expmap2rotmat",
    "rotmat2euler",
    "rotmat2quat",
    "expmap2quat",
    "quat2expmap",
    "rotmat2expmap",
    "quat_norm_valid",
    "rodrigues",
    "h36m_skeleton",
    "fkl",
    "expmap2xyz",
    "ang2joint",
    "load_smpl_skeleton",
]
