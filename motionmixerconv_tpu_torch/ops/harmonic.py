"""Fused harmonic embedding x Dense (forward): the CUDA kernel's wrapper,
its autograd Function and its plain PyTorch version.

Counterpart of ``make_fused_harmonic_dense`` in
``motionmixerconv_tpu/ops/pallas_harmonic.py``. The kernel
(``csrc/harmonic_dense.cu``) computes ``embed_mlp(harmonic_features(x))``
without writing the (R, 2nD) embedding to device memory. It takes the
weights i-major, (2, n, D, E): ``reorder_weight`` turns torch's (E, 2nD)
``embed_mlp.weight`` (feature index s*nD + d*n + i) into that layout, and
``PoseEncoder`` keeps the result until the parameter changes, so a call
launches only the kernel. The backward kernel is not ported yet: the
Function's backward raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..models.encoding import harmonic_features
from ._build import MAX_SMEM_BYTES, Counter, check, load_library, stream_ptr

LAUNCHES = Counter()     # kernel launches (CUDA tensors)
PLAIN_CALLS = Counter()  # calls served by the plain version (CPU tensors)

ROWS_PER_BLOCK = 16
IMPLS = ("direct", "doubling")


def reorder_weight(weight: torch.Tensor, n: int, d_in: int) -> torch.Tensor:
    """torch (E, 2nD) d-major -> the kernel's (2, n, D, E) i-major."""
    e = weight.shape[0]
    return (weight.t().reshape(2, d_in, n, e).permute(0, 2, 1, 3)
            .contiguous())


def harmonic_dense_plain(x2d: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, freqs: torch.Tensor,
                         impl: str = "direct") -> torch.Tensor:
    """The kernel's function in plain torch: (R, D) -> (R, E)."""
    n = freqs.numel()
    embed = harmonic_features(x2d, n, float(freqs[0]), impl, freqs)
    return F.linear(embed, weight, bias)


def _rows_per_block(e: int, max_outputs: int) -> int:
    return max(1, min(ROWS_PER_BLOCK, max_outputs // e))


def harmonic_dense_fwd(x2d: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, freqs: torch.Tensor,
                       impl: str = "direct",
                       weight_imajor: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """(R, D) -> (R, E): the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors, an error otherwise. ``weight_imajor`` is
    ``reorder_weight(weight, n, D)`` where the caller keeps one; without it
    the kernel's call reorders the weight first."""
    if impl not in IMPLS:
        raise ValueError(f"unknown harmonic impl {impl!r}")
    ts = (x2d, weight, bias, freqs)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("harmonic_dense takes float32 tensors")
    if any(t.device != x2d.device for t in ts):
        raise ValueError("harmonic_dense: tensors on different devices")
    if x2d.dim() != 2 or freqs.dim() != 1 or freqs.numel() < 1:
        raise ValueError("expected x2d (R, D) and freqs (n,) with n >= 1")
    r, d = x2d.shape
    n = freqs.numel()
    e = weight.shape[0]
    if tuple(weight.shape) != (e, 2 * n * d) or tuple(bias.shape) != (e,):
        raise ValueError(
            f"expected weight ({e}, {2 * n * d}) and bias ({e},), got "
            f"{tuple(weight.shape)} and {tuple(bias.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("harmonic_dense takes contiguous tensors")
    if weight_imajor is not None and (
            tuple(weight_imajor.shape) != (2, n, d, e)
            or weight_imajor.dtype != torch.float32
            or weight_imajor.device != x2d.device
            or not weight_imajor.is_contiguous()):
        raise ValueError(
            f"weight_imajor must be a contiguous float32 (2, {n}, {d}, {e}) "
            f"tensor on {x2d.device}")
    if x2d.device.type == "cpu":
        PLAIN_CALLS.add()
        return harmonic_dense_plain(x2d, weight, bias, freqs, impl)
    if x2d.device.type != "cuda":
        raise RuntimeError(f"harmonic_dense: no kernel for {x2d.device}")
    lib = load_library()
    rt = _rows_per_block(e, lib.mmc_harmonic_max_outputs_per_tile())
    if e > lib.mmc_harmonic_max_outputs_per_tile() or \
            lib.mmc_harmonic_smem_bytes(d, e, rt) > MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"harmonic_dense kernel: D={d}, E={e} exceed its shared memory "
            "or per-thread output limits")
    out = torch.empty((r, e), device=x2d.device, dtype=torch.float32)
    if r == 0:
        return out
    wsc = weight_imajor if weight_imajor is not None else \
        reorder_weight(weight, n, d)
    with torch.cuda.device(x2d.device):
        err = lib.mmc_harmonic_dense_fwd(
            x2d.data_ptr(), wsc.data_ptr(), bias.data_ptr(), freqs.data_ptr(),
            out.data_ptr(), r, d, e, n, int(impl == "doubling"), rt,
            stream_ptr(x2d.device))
    check(lib, err, "harmonic_dense_fwd")
    LAUNCHES.add()
    return out


class HarmonicDense(torch.autograd.Function):
    """Forward through the kernel (or, on the CPU, its plain version).
    No backward yet: it raises rather than differentiate the plain version."""

    @staticmethod
    def forward(ctx, x2d, weight, bias, freqs, impl, weight_imajor):
        return harmonic_dense_fwd(x2d, weight, bias, freqs, impl, weight_imajor)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "harmonic_dense: the backward kernel lands with the training slice")


def harmonic_dense(x2d: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   freqs: torch.Tensor, impl: str = "direct",
                   weight_imajor: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """``embed_mlp(harmonic_features(x2d))`` as one kernel: (R, D) -> (R, E)."""
    return HarmonicDense.apply(x2d.contiguous(), weight, bias, freqs, impl,
                               weight_imajor)
