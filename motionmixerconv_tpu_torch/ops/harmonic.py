"""Fused harmonic embedding x Dense: the CUDA kernels' wrappers (forward and
backward), their autograd Function and their plain PyTorch versions.

Counterpart of ``make_fused_harmonic_dense`` in
``motionmixerconv_tpu/ops/pallas_harmonic.py``. The kernel
(``csrc/harmonic_dense.cu``) computes ``embed_mlp(harmonic_features(x))``
without writing the (R, 2nD) embedding to device memory. It takes the
weights i-major, (2, n, D, E): ``reorder_weight`` turns torch's (E, 2nD)
``embed_mlp.weight`` (feature index s*nD + d*n + i) into that layout, and
``PoseEncoder`` keeps the result until the parameter changes, so a call
launches only the kernel. The backward kernel computes dW (straight into
torch's layout), db and, only when the input needs a gradient, dx; the
plain backward writes the same formula out rather than differentiating
``harmonic_features``, whose doubling recurrence autograd would
differentiate step by step to another gradient.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..models.encoding import harmonic_features
from ._build import MAX_SMEM_BYTES, Counter, check, load_library, stream_ptr

LAUNCHES = Counter()      # forward kernel launches (CUDA tensors)
LAUNCHES_BWD = Counter()  # backward kernel launches (CUDA tensors)
PLAIN_CALLS = Counter()   # forward or backward calls served by a plain
                          # version (CPU tensors)

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


def harmonic_dense_bwd_plain(x2d: torch.Tensor, g: torch.Tensor,
                             weight: torch.Tensor, freqs: torch.Tensor,
                             impl: str = "direct", need_dx: bool = True):
    """The backward kernel's function in plain torch: (dx or None, dW, db)
    for the upstream gradient ``g`` (R, E); dW in torch's (E, 2nD) layout.

    dx_r = sum_i f_i (c_i * (g_r Ws_i^T) - s_i * (g_r Wc_i^T)) at the
    features the forward used: under doubling the recurrence's own (s_i,
    c_i), the analytic gradient the TPU kernel defines."""
    n = freqs.numel()
    r, d = x2d.shape
    feats = harmonic_features(x2d, n, float(freqs[0]), impl, freqs)
    dw = g.t() @ feats
    db = g.sum(0)
    if not need_dx:
        return None, dw, db
    nd = n * d
    ge = g @ weight  # (R, 2nD): the gradient at the embedding
    s, c = feats[:, :nd].reshape(r, d, n), feats[:, nd:].reshape(r, d, n)
    gs, gc = ge[:, :nd].reshape(r, d, n), ge[:, nd:].reshape(r, d, n)
    return ((c * gs - s * gc) * freqs).sum(-1), dw, db


def _rows_per_block(e: int, max_outputs: int) -> int:
    return max(1, min(ROWS_PER_BLOCK, max_outputs // e))


def _check_args(x2d, weight, freqs, impl, weight_imajor, *more):
    """Validate what both kernels take; returns (R, D, n, E)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown harmonic impl {impl!r}")
    ts = (x2d, weight, freqs, *more)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("harmonic_dense takes float32 tensors")
    if any(t.device != x2d.device for t in ts):
        raise ValueError("harmonic_dense: tensors on different devices")
    if x2d.dim() != 2 or freqs.dim() != 1 or freqs.numel() < 1:
        raise ValueError("expected x2d (R, D) and freqs (n,) with n >= 1")
    r, d = x2d.shape
    n = freqs.numel()
    e = weight.shape[0]
    if tuple(weight.shape) != (e, 2 * n * d):
        raise ValueError(
            f"expected weight ({e}, {2 * n * d}), got {tuple(weight.shape)}")
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
    return r, d, n, e


def harmonic_dense_fwd(x2d: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, freqs: torch.Tensor,
                       impl: str = "direct",
                       weight_imajor: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """(R, D) -> (R, E): the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors, an error otherwise. ``weight_imajor`` is
    ``reorder_weight(weight, n, D)`` where the caller keeps one; without it
    the kernel's call reorders the weight first."""
    r, d, n, e = _check_args(x2d, weight, freqs, impl, weight_imajor, bias)
    if tuple(bias.shape) != (e,):
        raise ValueError(
            f"expected weight ({e}, {2 * n * d}) and bias ({e},), got "
            f"{tuple(weight.shape)} and {tuple(bias.shape)}")
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


def harmonic_dense_bwd(x2d: torch.Tensor, g: torch.Tensor,
                       weight: torch.Tensor, freqs: torch.Tensor,
                       impl: str = "direct",
                       weight_imajor: Optional[torch.Tensor] = None,
                       need_dx: bool = True):
    """(dx or None, dW (E, 2nD), db (E,)) for the upstream gradient ``g``
    (R, E): the CUDA kernels for CUDA tensors, the plain version for CPU
    tensors, an error otherwise. dx is computed only with ``need_dx``."""
    r, d, n, e = _check_args(x2d, weight, freqs, impl, weight_imajor, g)
    if tuple(g.shape) != (r, e):
        raise ValueError(f"expected g ({r}, {e}), got {tuple(g.shape)}")
    if x2d.device.type == "cpu":
        PLAIN_CALLS.add()
        return harmonic_dense_bwd_plain(x2d, g, weight, freqs, impl, need_dx)
    if x2d.device.type != "cuda":
        raise RuntimeError(f"harmonic_dense: no kernel for {x2d.device}")
    lib = load_library()
    max_out = lib.mmc_harmonic_max_outputs_per_tile()
    sms = torch.cuda.get_device_properties(x2d.device).multi_processor_count
    # dx: enough row blocks to cover the SMs, no more rows than registers hold
    rt = max(1, min(ROWS_PER_BLOCK, max_out // d, -(-r // sms)))
    if d * e > lib.mmc_harmonic_bwd_max_slab_outputs() or d > max_out or \
            lib.mmc_harmonic_bwd_smem_bytes(d, e, rt) > MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"harmonic_dense backward kernel: D={d}, E={e} exceed its shared "
            "memory or per-thread output limits")
    kw = dict(device=x2d.device, dtype=torch.float32)
    dw = torch.empty((e, 2 * n * d), **kw)
    db = torch.empty((e,), **kw)
    dx = torch.empty((r, d), **kw) if need_dx else None
    if r == 0:
        return (dx, dw.zero_(), db.zero_())
    wsc = weight_imajor if weight_imajor is not None else \
        reorder_weight(weight, n, d)
    with torch.cuda.device(x2d.device):
        err = lib.mmc_harmonic_dense_bwd(
            x2d.data_ptr(), g.data_ptr(), wsc.data_ptr(), freqs.data_ptr(),
            dw.data_ptr(), db.data_ptr(),
            dx.data_ptr() if dx is not None else None, r, d, e, n,
            int(impl == "doubling"), rt, stream_ptr(x2d.device))
    check(lib, err, "harmonic_dense_bwd")
    LAUNCHES_BWD.add()
    return dx, dw, db


class HarmonicDense(torch.autograd.Function):
    """Forward and backward through the kernels (on the CPU, through their
    plain versions). ``freqs``, ``impl`` and ``weight_imajor`` take no
    gradient; dx is computed only when ``x2d`` needs one."""

    @staticmethod
    def forward(ctx, x2d, weight, bias, freqs, impl, weight_imajor):
        ctx.impl = impl
        ctx.save_for_backward(x2d, weight, freqs, weight_imajor)
        return harmonic_dense_fwd(x2d, weight, bias, freqs, impl, weight_imajor)

    @staticmethod
    def backward(ctx, grad_out):
        x2d, weight, freqs, weight_imajor = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx, dw, db = harmonic_dense_bwd(
            x2d, grad_out.contiguous(), weight, freqs, ctx.impl,
            weight_imajor, need_dx=need_x)
        return (dx, dw if need_w else None, db if need_b else None,
                None, None, None)


def harmonic_dense(x2d: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   freqs: torch.Tensor, impl: str = "direct",
                   weight_imajor: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """``embed_mlp(harmonic_features(x2d))`` as one kernel: (R, D) -> (R, E)."""
    return HarmonicDense.apply(x2d.contiguous(), weight, bias, freqs, impl,
                               weight_imajor)
