"""DCT/IDCT trajectory-space helpers (PyTorch).

Counterpart of ``motionmixerconv_tpu/geometry/dct.py``: the reference's
defined-but-unused DCT utilities (h36m/utils/utils_mixer.py:76-114,
h36m/utils/data_utils.py:588-597), an orthonormal DCT-II matrix pair and
the sequence transforms over the time axis.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def get_dct_matrix(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(dct_m, idct_m): the orthonormal DCT-II matrix and its inverse, in
    float64; the reference's double loop (utils_mixer.py:76-85),
    vectorised."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    w = np.full((n, 1), np.sqrt(2.0 / n))
    w[0] = np.sqrt(1.0 / n)
    dct_m = w * np.cos(np.pi * (i + 0.5) * k / n)
    idct_m = np.linalg.inv(dct_m)
    return dct_m.astype(np.float64), idct_m.astype(np.float64)


def _matrix(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(m, dtype=like.dtype, device=like.device)


def dct_transform(seq: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> DCT coefficients over the time axis
    (utils_mixer.py:89-100)."""
    dct_m, _ = get_dct_matrix(seq.shape[1])
    return torch.einsum("kt,btd->bkd", _matrix(dct_m, seq), seq)


def idct_transform(coeffs: torch.Tensor) -> torch.Tensor:
    """Inverse of ``dct_transform`` (utils_mixer.py:103-114)."""
    _, idct_m = get_dct_matrix(coeffs.shape[1])
    return torch.einsum("tk,bkd->btd", _matrix(idct_m, coeffs), coeffs)
