"""Batched rotation-representation conversions in PyTorch.

Counterpart of ``motionmixerconv_tpu/geometry/rotations.py`` (reference:
h36m/utils/data_utils.py:467-585). Every function takes ``(..., )`` batches
on any device; the gimbal-lock branches of ``rotmat2euler`` are evaluated
densely and combined with masks, so nothing partitions the batch on the
host. The reference's epsilon constants are kept.
"""

from __future__ import annotations

import math

import torch


def _skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix for (..., 3) vectors."""
    zero = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )


def _eye_like(k: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=k.dtype, device=k.device).expand(k.shape)


def expmap2rotmat(r: torch.Tensor) -> torch.Tensor:
    """Exponential map (..., 3) -> rotation matrix (..., 3, 3) (Rodrigues),
    with the reference's ``theta + 1e-7`` normalisation epsilon."""
    theta = torch.linalg.norm(r, dim=-1)
    r0 = r / (theta[..., None] + 1e-7)
    k = _skew(r0)
    sin_t = torch.sin(theta)[..., None, None]
    cos_t = torch.cos(theta)[..., None, None]
    return _eye_like(k) + sin_t * k + (1.0 - cos_t) * (k @ k)


def rotmat2euler(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> euler angles (..., 3), with the
    reference's special case at ``R[0, 2] == +/-1`` as masks."""
    r02 = R[..., 0, 2]
    spec_pos = r02 == 1.0
    spec_neg = r02 == -1.0
    special = spec_pos | spec_neg

    e1 = -torch.arcsin(torch.clamp(r02, -1.0, 1.0))
    cos_e1 = torch.cos(e1)
    # where special, cos_e1 == 0; guard the division (the mask discards it)
    safe_cos = torch.where(special, torch.ones_like(cos_e1), cos_e1)
    e0 = torch.arctan2(R[..., 1, 2] / safe_cos, R[..., 2, 2] / safe_cos)
    e2 = torch.arctan2(R[..., 0, 1] / safe_cos, R[..., 0, 0] / safe_cos)

    delta = torch.arctan2(R[..., 0, 1], R[..., 0, 2])
    se1 = torch.where(spec_pos, torch.full_like(delta, -math.pi / 2.0),
                      torch.full_like(delta, math.pi / 2.0))
    return torch.stack(
        [
            torch.where(special, delta, e0),
            torch.where(special, se1, e1),
            torch.where(special, torch.zeros_like(delta), e2),
        ],
        dim=-1,
    )


def rotmat2quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (w, x, y, z), with the reference's
    ``r_norm + 1e-8`` epsilon (data_utils.py:512-536)."""
    rotdiff = R - R.transpose(-1, -2)
    r = torch.stack(
        [-rotdiff[..., 1, 2], rotdiff[..., 0, 2], -rotdiff[..., 0, 1]], dim=-1)
    r_norm = torch.linalg.norm(r, dim=-1)
    sintheta = r_norm / 2.0
    r0 = r / (r_norm[..., None] + 1e-8)
    costheta = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) / 2.0
    theta = torch.arctan2(sintheta, costheta)
    w = torch.cos(theta / 2.0)
    xyz = r0 * torch.sin(theta / 2.0)[..., None]
    return torch.cat([w[..., None], xyz], dim=-1)


def expmap2quat(exp: torch.Tensor) -> torch.Tensor:
    """Exponential map -> quaternion, with the reference's ``theta + 1e-7``
    epsilon (data_utils.py:539-552)."""
    theta = torch.linalg.norm(exp, dim=-1, keepdim=True)
    v = exp / (theta + 1e-7)
    return torch.cat([torch.cos(theta / 2.0), v * torch.sin(theta / 2.0)],
                     dim=-1)


_F32_EPS = float(torch.finfo(torch.float32).eps)


def quat_norm_valid(q: torch.Tensor, tol: float = 1e-3) -> torch.Tensor:
    """(..., 4) -> (...,) bool: which quaternions pass the reference's
    unit-norm guard (its ``quat2expmap`` raises instead; batched code
    exposes the guard as this mask)."""
    return torch.abs(torch.linalg.norm(q, dim=-1) - 1.0) <= tol


def quat2expmap(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) -> exponential map, batched, with the
    reference's float32-eps normalisation and the theta > pi shortening
    (data_utils.py:97-125)."""
    sinhalf = torch.linalg.norm(q[..., 1:], dim=-1)
    coshalf = q[..., 0]
    r0 = q[..., 1:] / (sinhalf[..., None] + _F32_EPS)
    theta = 2.0 * torch.arctan2(sinhalf, coshalf)
    theta = torch.remainder(theta + 2.0 * math.pi, 2.0 * math.pi)
    flip = theta > math.pi
    theta = torch.where(flip, 2.0 * math.pi - theta, theta)
    r0 = torch.where(flip[..., None], -r0, r0)
    return r0 * theta[..., None]


def rotmat2expmap(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> exponential map = quat2expmap(rotmat2quat(R))
    (data_utils.py:73-74)."""
    return quat2expmap(rotmat2quat(R))


def rodrigues(r: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle -> rotation matrix, SMPL convention (utils/ang2joint.py:
    62-88), with the deterministic ``sqrt(|r|^2 + eps^2)`` guard in place
    of the reference's 1e-8 gaussian jitter."""
    theta = torch.sqrt(torch.sum(r * r, dim=-1) + eps * eps)
    r_hat = r / theta[..., None]
    cos = torch.cos(theta)[..., None, None]
    sin = torch.sin(theta)[..., None, None]
    outer = r_hat[..., :, None] * r_hat[..., None, :]
    return cos * _eye_like(outer) + (1.0 - cos) * outer + sin * _skew(r_hat)
