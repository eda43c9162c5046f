"""Frozen operation and byte counts of the port's four kernels, and the
H100's data-sheet peaks.

A copy, held apart from the program so that the yardstick does not move
when the port changes: ``b1_work``, ``b1_bwd_work``, ``b2_work``,
``b3_work``, ``b4_work`` and ``bound`` as ``chip_smoke.py`` has them, and
the peaks of ``motionmixerconv_tpu_torch/profiling.py``. Each count takes
its shapes as plain numbers or as any object with the named attributes
(``ConvSpec`` below, or the port's own spec classes).

Counting rules: each input, weight and output element is moved once;
every multiply, add, comparison and transcendental is one operation (a
multiply-add two); stencil taps on the zero padding are not counted.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

# NVIDIA's H100 SXM data sheet at its full 700 W, dense rates: float32
# outside the tensor cores (the port pins TF32 off), and HBM3 bandwidth.
H100 = "NVIDIA H100 80GB HBM3"
PEAK_FLOPS_F32 = {H100: 67e12}
PEAK_BYTES = {H100: 3.35e12}


@dataclass(frozen=True)
class ConvSpec:
    """Shapes of a ConvMixer core after its encoder: T input frames, E the
    embedding width, P output frames, D output dims, H the SE width
    (T // r_se), C channels."""

    T: int
    E: int
    P: int
    D: int
    H: int
    num_blocks: int
    k1: Tuple[int, int]
    k2: Tuple[int, int]
    twice: bool = True
    use_se: bool = True
    C: int = 1


def in_plane_taps(n: int, k: int) -> int:
    """Taps of a width-``k`` 'same' stencil that fall inside the ``n``
    positions, summed over the outputs (torch's padding: floor((k-1)/2) on
    the left)."""
    left = (k - 1) // 2
    return sum(min(n, i - left + k) - max(0, i - left) for i in range(n))


def conv_taps(spec, k) -> int:
    """In-plane multiply-adds of one (kh, kw) 'same' stencil over a (T, E)
    plane, for one input and one output channel."""
    return in_plane_taps(spec.T, k[0]) * in_plane_taps(spec.E, k[1])


def b2_work(spec, batch: int, n_weights: int):
    """(bytes, operations) of the single-channel ConvMixer core (B2) for
    ``batch`` samples and ``n_weights`` weight floats."""
    T, E, P, D, H = spec.T, spec.E, spec.P, spec.D, spec.H
    te = T * E

    def branch(k):
        ops = 7 * te                        # LayerNorm
        ops += 2 * conv_taps(spec, k) + te  # stencil + bias
        ops += 8 * te + 2 * te              # mish or GELU, BN affine
        if spec.use_se:
            ops += te + 4 * T * H + 4 * T + te  # squeeze, fc1/fc2, sigmoid, gate
        return ops + te                     # residual

    per_block = branch(spec.k1) + (
        branch(spec.k2) if spec.twice else
        (2 * te + 4 * T * H + 4 * T if spec.use_se else te))
    decoder = 7 * te + 2 * T * P * E + P * E + 2 * P * E + 8 * P * E \
        + 2 * P * E * D + P * D
    ops = batch * (spec.num_blocks * per_block + decoder)
    nbytes = 4 * (batch * T * E + n_weights + batch * P * D)
    return nbytes, ops


def b3_work(spec, batch: int, n_weights: int):
    """(bytes, operations) of the multi-channel ConvMixer core (B3): the
    C x C convolutions are 2 * C * C multiply-adds per in-plane tap."""
    C, T, E, P, D, H = spec.C, spec.T, spec.E, spec.P, spec.D, spec.H
    n = C * T * E

    def se_and_residual():
        ops = (2 * n + 4 * T * H + 4 * T) if spec.use_se else 0
        return ops + n

    def branch(k):
        ops = 7 * n                                # LayerNorm
        ops += 2 * C * C * conv_taps(spec, k) + n  # the C x C conv, bias
        ops += 8 * n + 2 * n                       # mish or GELU, BN affine
        return ops + se_and_residual()

    per_block = branch(spec.k1) + (branch(spec.k2) if spec.twice
                                   else se_and_residual())
    decoder = 7 * n + 2 * C * T * P * E + C * P * E + 2 * C * P * E \
        + P * E + 8 * P * E + 2 * P * E * D + P * D
    ops = batch * (spec.num_blocks * per_block + decoder)
    nbytes = 4 * (batch * n + n_weights + batch * P * D)
    return nbytes, ops


def b4_work(spec, batch: int, n_weights: int):
    """(bytes, operations) of the fused MlpMixer forward (B4); ``spec``
    has T, D, H, P, NC, S, tok, ch, num_blocks, use_se, has_tok, has_ch."""
    T, D, H, P, NC, S = spec.T, spec.D, spec.H, spec.P, spec.NC, spec.S
    tok, ch, th = spec.tok, spec.ch, spec.T * spec.H
    se = (2 * th + 4 * T * S + 4 * T) if spec.use_se else 0
    per_block = 0
    if spec.has_tok:
        per_block += (7 * th + 2 * H * T * tok + 9 * H * tok
                      + 2 * H * tok * T + 2 * th + se + th)
    else:
        per_block += se + th
    if spec.has_ch:
        per_block += (7 * th + 2 * T * H * ch + 9 * T * ch
                      + 2 * T * ch * H + 2 * th + se + th)
    else:
        per_block += th
    embed = 2 * T * D * H + th
    head = 7 * th + 2 * H * T * P + P * H + 2 * P * H * NC + P * NC
    ops = batch * (embed + spec.num_blocks * per_block + head)
    nbytes = 4 * (batch * T * D + n_weights + batch * P * NC)
    return nbytes, ops


def b1_work(rows: int, d: int, n: int, e: int, impl: str = "direct"):
    """(bytes, operations) of the harmonic encoder's forward (B1-fwd) for
    ``rows`` rows of ``d`` dims, ``n`` harmonics, ``e`` outputs."""
    nbytes = 4 * (rows * d + 2 * n * d * e + e + n + rows * e)
    ops = 2 * rows * (2 * n * d) * e + rows * e  # the contraction, the bias
    if impl == "direct":
        ops += rows * d * n * 3                  # angle, sin, cos
    else:
        ops += rows * d * 3 + rows * d * (n - 1) * 9
    return nbytes, ops


def b1_bwd_work(rows: int, d: int, n: int, e: int, impl: str = "direct",
                with_dx: bool = False):
    """(bytes, operations) of the harmonic encoder's backward (B1-bwd): dW
    and db always, dx when asked."""
    nbytes = 4 * (rows * d + rows * e + n + 2 * n * d * e + e)
    ops = 2 * rows * (2 * n * d) * e + rows * e  # dW = feat^T g, db
    if impl == "direct":
        ops += rows * d * n * 3
    else:
        ops += rows * d * 3 + rows * d * (n - 1) * 9
    if with_dx:
        nbytes += 4 * (2 * n * d * e + rows * d)
        ops += 2 * rows * (2 * n * d) * e
        ops += rows * d * n * 5
    return nbytes, ops


def bound(nbytes: int, ops: int, kind: str = H100):
    """(the least ms the card could take, its limit): bytes over the memory
    rate or float32 operations over the float32 rate, whichever is
    larger."""
    t_bytes = nbytes / PEAK_BYTES[kind] * 1e3
    t_ops = ops / PEAK_FLOPS_F32[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
