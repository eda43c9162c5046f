"""Pose encoding: optional NeRF-style harmonic embedding + linear projection.

Counterpart of ``motionmixerconv_tpu/models/encoding.py`` (``PoseEncoder``)
with the reference torch module names (``frequencies``, ``embed_mlp``,
``channelUpscaling``), so a reference state_dict loads strictly.

Harmonic layout: feature-major, index ``d*n + i``, the sin block before the
cos block — the reference's ``(x[..., None] * frequencies).view(..., -1)``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn


def _double(s, c):
    """One normalized angle-doubling step: (sin a, cos a) -> (sin 2a, cos 2a).

    Both doubling expressions are homogeneous of degree 2, so dividing by
    r = s^2 + c^2 pins the radius to 1 exactly; the unnormalized recurrence
    overflows past ~28 doublings in f32. The CUDA kernel
    (csrc/harmonic_dense.cu) evaluates the same expression.
    """
    inv = 1.0 / (s * s + c * c)
    return 2.0 * (s * c) * inv, (c - s) * (c + s) * inv


def harmonic_frequencies(n_harmonic: int, omega0: float) -> torch.Tensor:
    """f_i = omega0 * 2**i as float32 (the reference ``frequencies`` buffer)."""
    return torch.from_numpy(
        (omega0 * (2.0 ** np.arange(n_harmonic))).astype(np.float32))


def harmonic_features(x: torch.Tensor, n_harmonic: int, omega0: float,
                      impl: str = "direct",
                      freqs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., D) -> (..., 2*n*D) sin/cos features in the reference layout.

    ``impl="doubling"`` computes one sin/cos pair and derives every further
    harmonic by the normalized doubling recurrence; it agrees with "direct"
    below the f32 noise crossover (harmonic ~26 at production input
    scales) and, like direct trig, is noise above it. ``freqs`` is the
    ``frequencies`` buffer where the caller holds one on the device.
    """
    if impl == "doubling":
        if n_harmonic <= 0:
            return x[..., :0]
        a = omega0 * x
        s, c = torch.sin(a), torch.cos(a)
        sins, coss = [s], [c]
        for _ in range(n_harmonic - 1):
            s, c = _double(s, c)
            sins.append(s)
            coss.append(c)
        sin = torch.stack(sins, dim=-1).reshape(*x.shape[:-1], -1)
        cos = torch.stack(coss, dim=-1).reshape(*x.shape[:-1], -1)
        return torch.cat([sin, cos], dim=-1)
    if impl != "direct":
        raise ValueError(f"unknown harmonic impl {impl!r}")
    if n_harmonic <= 0:
        return x[..., :0]
    if freqs is None:
        freqs = harmonic_frequencies(n_harmonic, omega0).to(x.device)
    e = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)
    return torch.cat([torch.sin(e), torch.cos(e)], dim=-1)


class PoseEncoder(nn.Module):
    """(B, in_nTP, dimPosIn) -> (B, in_nTP, dimPosEmb, conv_nChan).

    ``fused=True`` computes harmonic embedding + ``embed_mlp`` in the
    hand-written kernel (``ops/harmonic.py``, forward only); parameters are
    those of the plain module, so checkpoints are interchangeable.
    ``precomputed=True`` takes the already-computed (B, T, 2nD) embedding.
    ``embed_dtype`` is the storage dtype of the materialized embedding.
    """

    def __init__(self, dimPosIn: int, dimPosEmb: int, conv_nChan: int = 1,
                 n_harmonic_functions: int = 64, omega0: float = 0.1,
                 dtype=None, fused: bool = False, precomputed: bool = False,
                 harmonic_impl: str = "direct",
                 embed_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if dtype is not None:
            raise NotImplementedError(
                "compute dtype (bf16 mixed precision) is not ported yet; "
                "the port runs float32 (ROADMAP queue A item 21)")
        nh = n_harmonic_functions
        if harmonic_impl != "direct" and precomputed and nh > 0:
            raise ValueError(
                f"harmonic_impl={harmonic_impl!r} does not combine with the "
                "corpus-level embedding cache (precomputed embeddings are "
                "direct trig)")
        if fused and precomputed and nh > 0:
            raise ValueError(
                "fused=True does not combine with the corpus-level embedding "
                "cache: the fused kernel computes the harmonics itself from "
                "the RAW pose input")
        if embed_dtype is not None and nh > 0 and (fused or precomputed):
            raise ValueError(
                "embed_dtype only applies to the per-step materialized "
                "harmonic embedding; it has no effect under fused=True or "
                "precomputed=True — drop one of the flags")
        self.dimPosIn = dimPosIn
        self.dimPosEmb = dimPosEmb
        self.conv_nChan = conv_nChan
        self.n_harmonic_functions = nh
        self.omega0 = omega0
        self.fused = fused and nh > 0
        self.precomputed = precomputed
        self.harmonic_impl = harmonic_impl
        self.embed_dtype = embed_dtype
        if nh > 0:
            self.register_buffer("frequencies", harmonic_frequencies(nh, omega0))
            dim_harmonic = nh * dimPosIn * 2
        else:
            dim_harmonic = dimPosIn
        self.embed_mlp = nn.Linear(dim_harmonic, dimPosEmb)
        self.channelUpscaling = nn.Linear(1, conv_nChan)
        self._imajor = None      # embed_mlp.weight in the kernel's layout
        self._imajor_key = None  # (device, data_ptr, version) it came from

    def kernel_weight(self) -> torch.Tensor:
        """``embed_mlp.weight`` in the fused kernel's i-major layout.

        Rebuilt on every call in training mode and while a CUDA graph is
        being captured, so that a training step and a captured forward
        reorder the weight on the device each time they run (a replay does
        not re-run this host code, nor does it bump the parameter's
        version). Otherwise (serving) kept until the parameter moves or
        changes in place."""
        from ..ops.harmonic import reorder_weight

        w = self.embed_mlp.weight
        if self.training or (w.is_cuda
                             and torch.cuda.is_current_stream_capturing()):
            self._imajor_key = None
            with torch.no_grad():
                return reorder_weight(w, self.n_harmonic_functions,
                                      self.dimPosIn)
        key = (w.device, w.data_ptr(), w._version)
        if key != self._imajor_key:
            with torch.no_grad():
                self._imajor = reorder_weight(
                    w, self.n_harmonic_functions, self.dimPosIn)
            self._imajor_key = key
        return self._imajor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nh = self.n_harmonic_functions
        if self.precomputed and nh > 0:
            y = self.embed_mlp(x)  # x IS the embedding
        elif self.fused:
            from ..ops.harmonic import harmonic_dense

            lead = x.shape[:-1]
            y = harmonic_dense(
                x.reshape(-1, self.dimPosIn), self.embed_mlp.weight,
                self.embed_mlp.bias, self.frequencies, self.harmonic_impl,
                self.kernel_weight(),
            ).reshape(*lead, self.dimPosEmb)
        else:
            embed = x if nh <= 0 else harmonic_features(
                x, nh, self.omega0, self.harmonic_impl, self.frequencies)
            if self.embed_dtype is not None and nh > 0:
                # storage rounding only; the projection runs in float32
                embed = embed.to(self.embed_dtype).to(x.dtype)
            y = self.embed_mlp(embed)
        return self.channelUpscaling(y[..., None])  # (B, T, E, C)
