"""Rotations, Human3.6M, CMU and SMPL forward kinematics, the DCT
trajectory transforms and the AMASS skeleton graph (PyTorch)."""

from .dct import dct_transform, get_dct_matrix, idct_transform
from .forward_kinematics import cmu_skeleton, expmap2xyz, fkl, h36m_skeleton
from .graph import get_adj_AMASS, normalize_A, spatio_temporal_graph
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
    "cmu_skeleton",
    "fkl",
    "expmap2xyz",
    "ang2joint",
    "load_smpl_skeleton",
    "get_adj_AMASS",
    "normalize_A",
    "spatio_temporal_graph",
    "get_dct_matrix",
    "dct_transform",
    "idct_transform",
]
