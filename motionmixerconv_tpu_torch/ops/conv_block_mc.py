"""The multi-channel ConvBlock (conv -> bias -> activation, C x C taps) as
one CUDA launch forward and two backward: the launch plan, the wrappers,
their autograd Function and their plain PyTorch versions.

``ConvBlock`` (``models/mixer_conv.py``) of two or more channels, at
stride 1 with odd kernels, 'same' padding and no compute dtype, computes
``a = act(conv(x) + b)`` through ``conv_block_mc`` on float32 CUDA tensors
whose plan fits a block's shared memory (``takes``). The kernels
(``csrc/conv_block_mc.cu``) take the place of cuDNN's convolution, its
data and weight gradients, the bias gradient and the activation's eager
chains. They replace no TPU kernel: in the JAX package XLA fused this
chain and no Pallas kernel stood for it. The float32 rate bounds them (at
the autoregressive training shape a forward is 307 MFLOP against 3 MB an
activation tensor): a register-blocked stencil over a tile staged in
shared memory.

The forward writes ``act'(z)`` beside ``a = act(z)`` where autograd needs
it (the two share their transcendental terms), and the Function saves x
and act'(z): the backward needs neither a third stencil pass for z nor a
transcendental of its own. The backward's
first launch writes dx and each block's partial weight and bias sums, its
second adds the partials in block order in float64: no float atomics, two
launches give identical bits, and concurrent calls share no scratch.

The plain versions are ``ConvBlock``'s modules, ``F.conv2d`` + bias + the
activation, and autograd's gradient of them; the wrappers take them only
for CPU tensors. This path shares no code with the single-channel
kernels (``ops/conv_block.py``), whose calls are bound by launch latency,
not by the float32 rate.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ._build import MAX_SMEM_BYTES, Counter, check, load_library, stream_ptr
from .activations import get_activation

LAUNCHES = Counter()      # forward kernel launches (CUDA tensors)
LAUNCHES_BWD = Counter()  # backward calls, two launches each (CUDA tensors)
PLAIN_CALLS = Counter()   # forward or backward calls served by a plain
                          # version (CPU tensors)

ACTIVATIONS = ("gelu", "mish")  # the kernels' activation index
TILES_TOO_LARGE = -1  # an entry's return where the plan's tiles exceed a
                      # block's shared memory (csrc kTilesTooLarge)

# The plan's constants (csrc/conv_block_mc.cu): a task's columns and
# output channels, the column tap counts compiled for and the chunk of the
# others, the most threads of a forward block, a backward block's threads
CB = 3
CO = 4
FIXED_KW = (1, 5, 9)
CHUNK = 8
FWD_THREADS = 640
BWD_THREADS = 320
MAX_BAND = 16  # a block's most rows
# a block's columns, tried in order until the backward's tiles fit
SLICE_WIDTHS = (48, 36, 24, 12, 6, 3)


@dataclass(frozen=True)
class Plan:
    """A call's tiles: a block of either kernel owns ``bt`` rows and ``be``
    columns of one sample's planes; a forward block has ``fwd_threads``
    threads (a stencil task each), a backward block BWD_THREADS, and ``s``
    row subsets of a weight-gradient task; ``smem_fwd`` and ``smem_bwd``
    their shared memory (``csrc/conv_block_mc.cu`` smem_bytes, computed
    alike; its entry ``mmc_conv_block_mc_smem_bytes`` says the same on the
    card)."""

    bt: int
    be: int
    fwd_threads: int
    s: int
    smem_fwd: int
    smem_bwd: int

    def blocks(self, n: int, t: int, e: int) -> int:
        return n * -(-t // self.bt) * -(-e // self.be)


def plan(c: int, t: int, e: int, kh: int, kw: int) -> Optional[Plan]:
    """The launch plan of a (C, T, E) plane with (kh, kw) taps: the widest
    slice whose backward tiles fit a block's shared memory, or None where
    none does."""
    cp = -(-c // CO) * CO
    span = kw if kw in FIXED_KW else -(-kw // CHUNK) * CHUNK
    qc = kw if kw in FIXED_KW else CHUNK
    sum_tasks = (kh * c * -(-kw // qc) + 1) * (cp // CO)
    weights = c * kh * kw * cp
    bt = min(t, MAX_BAND)
    for be in SLICE_WIDTHS:
        tile = c * (bt + kh - 1) * ((be + span - 1) | 1)
        smem_bwd = 4 * (weights + bt * be * cp + 2 * tile
                        + max(tile, c * c * kh * kw + c))
        if smem_bwd > MAX_SMEM_BYTES:
            continue
        tasks = cp // CO * bt * (be // CB)  # the stencil's
        return Plan(bt, be, min(FWD_THREADS, -(-tasks // 32) * 32),
                    max(1, min(bt, BWD_THREADS // sum_tasks)),
                    4 * (weights + tile), smem_bwd)
    return None


def takes(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """Whether the kernels compute ``conv_block_mc`` on ``x`` (N, C, T, E)
    with ``weight`` (C, C, kh, kw): float32 tensors on a CUDA device whose
    plan fits a block's shared memory. ``ConvBlock`` has already checked
    the rest of the domain (channels, stride, odd kernels, padding) from
    its own construction."""
    return (x.is_cuda and x.dtype == torch.float32
            and weight.dtype == torch.float32 and x.dim() == 4
            and plan(x.shape[1], x.shape[2], x.shape[3], *weight.shape[2:])
            is not None)


def device_launches() -> tuple:
    """(forward, backward) kernel launches the current CUDA device has run
    since the library was loaded, as the kernels count them on the device
    (a backward call's first kernel counts it): replays of a captured CUDA
    graph included, which ``LAUNCHES`` and ``LAUNCHES_BWD`` (counted where
    a wrapper launches) cannot see. Waits for the device; callers read
    differences."""
    lib = load_library()
    out = (ctypes.c_ulonglong * 2)()
    torch.cuda.synchronize()
    check(lib, lib.mmc_conv_block_mc_device_launches(ctypes.addressof(out)),
          "conv_block_mc kernels' device launch counts")
    return int(out[0]), int(out[1])


def conv_block_mc_plain(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, activation: str) -> torch.Tensor:
    """The forward kernel's function in plain torch: ``ConvBlock``'s own
    composition, conv with 'same' padding and the bias, then the
    activation."""
    return get_activation(activation)(F.conv2d(x, weight, bias,
                                               padding="same"))


def conv_block_mc_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                            weight: torch.Tensor, bias: torch.Tensor,
                            activation: str):
    """The backward kernels' function in plain torch: (dx, dw, db) for the
    upstream gradient ``g`` of ``a``, autograd's through
    ``conv_block_mc_plain``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, weight, bias)]
        return torch.autograd.grad(
            conv_block_mc_plain(*leaves, activation), leaves, g)


def _check_args(x, weight, bias, activation, *more):
    """Validate what the kernels take; returns (N, C, T, E, kh, kw)."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"Unknown activation function type: {activation}")
    if x.dim() != 4 or weight.dim() != 4 \
            or tuple(weight.shape[:2]) != (x.shape[1], x.shape[1]) \
            or tuple(bias.shape) != (x.shape[1],) \
            or weight.shape[2] % 2 == 0 or weight.shape[3] % 2 == 0:
        raise ValueError(
            "conv_block_mc takes x (N, C, T, E), weight (C, C, kh, kw) of "
            f"odd kh and kw and bias (C,), got {tuple(x.shape)}, "
            f"{tuple(weight.shape)} and {tuple(bias.shape)}")
    for t in (x, weight, bias, *more):
        if t.device != x.device:
            raise ValueError("conv_block_mc: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError("conv_block_mc takes contiguous tensors")
    return (*x.shape, *weight.shape[2:])


def _cuda_plan(x, weight, *more) -> Plan:
    """The plan of CUDA tensors the kernels take; raise otherwise."""
    if x.device.type != "cuda":
        raise RuntimeError(f"conv_block_mc: no kernel for {x.device}")
    for t in (x, weight, *more):
        if t.dtype != torch.float32:
            raise TypeError("conv_block_mc's kernels take float32 tensors")
    p = plan(x.shape[1], x.shape[2], x.shape[3], *weight.shape[2:])
    if p is None:
        raise NotImplementedError(
            f"conv_block_mc: a plane of {tuple(x.shape[1:])} with taps "
            f"{tuple(weight.shape[2:])} exceeds the kernels' shared memory")
    return p


def _check_launch(lib, err: int, what: str) -> None:
    if err == TILES_TOO_LARGE:
        raise NotImplementedError(
            f"{what}: the plan's tiles exceed the device's shared memory")
    check(lib, err, what)


def conv_block_mc_fwd(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, activation: str,
                      with_grad: bool = False):
    """(a, da): a = act(conv(x) + b), (N, C, T, E), and with ``with_grad``
    da = act'(conv(x) + b) (else None): the CUDA kernel for CUDA tensors;
    for CPU tensors the plain version, which gives no da (its backward
    differentiates the modules again); an error otherwise."""
    n, c, t, e, kh, kw = _check_args(x, weight, bias, activation)
    if x.device.type == "cpu":
        PLAIN_CALLS.add()
        return conv_block_mc_plain(x, weight, bias, activation), None
    p = _cuda_plan(x, weight, bias)
    a = torch.empty_like(x)
    da = torch.empty_like(x) if with_grad else None
    if n == 0:
        return a, da
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.mmc_conv_block_mc_fwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), a.data_ptr(),
            da.data_ptr() if da is not None else None, n, c, t, e, kh, kw,
            p.bt, p.be, p.fwd_threads, ACTIVATIONS.index(activation),
            stream_ptr(x.device))
    _check_launch(lib, err, "conv_block_mc_fwd")
    LAUNCHES.add()
    return a, da


def conv_block_mc_bwd(x: torch.Tensor, da: Optional[torch.Tensor],
                      g: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, activation: str):
    """(dx, dw, db) for the upstream gradient ``g`` (N, C, T, E): the CUDA
    kernels for CUDA tensors, from the forward's ``da`` = act'(z); the
    plain version for CPU tensors (``da`` unused); an error otherwise."""
    n, c, t, e, kh, kw = _check_args(x, weight, bias, activation, g)
    if tuple(g.shape) != tuple(x.shape):
        raise ValueError(f"expected g {tuple(x.shape)}, got {tuple(g.shape)}")
    if x.device.type == "cpu":
        PLAIN_CALLS.add()
        return conv_block_mc_bwd_plain(x, g, weight, bias, activation)
    if da is None or tuple(da.shape) != tuple(x.shape) \
            or da.device != x.device or not da.is_contiguous():
        raise ValueError("conv_block_mc_bwd needs the forward's act'(z), "
                         "shaped as x, on the same device")
    p = _cuda_plan(x, weight, bias, g, da)
    dx, dw, db = (torch.empty_like(x), torch.empty_like(weight),
                  torch.empty_like(bias))
    if n == 0:
        return dx, dw.zero_(), db.zero_()
    part = torch.empty(p.blocks(n, t, e) * (c * c * kh * kw + c),
                       device=x.device, dtype=torch.float32)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.mmc_conv_block_mc_bwd(
            x.data_ptr(), da.data_ptr(), g.data_ptr(), weight.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), db.data_ptr(), part.data_ptr(),
            n, c, t, e, kh, kw, p.bt, p.be, BWD_THREADS, p.s,
            stream_ptr(x.device))
    _check_launch(lib, err, "conv_block_mc_bwd")
    LAUNCHES_BWD.add()
    return dx, dw, db


class ConvBlockMCFunction(torch.autograd.Function):
    """Forward and backward through the kernels (on the CPU, through their
    plain versions). ``activation`` takes no gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, activation):
        ctx.activation = activation
        a, da = conv_block_mc_fwd(x, weight, bias, activation,
                                  with_grad=True)
        ctx.save_for_backward(x, da, weight, bias)
        return a

    @staticmethod
    def backward(ctx, grad_out):
        x, da, weight, bias = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx, dw, db = conv_block_mc_bwd(x, da, grad_out.contiguous(), weight,
                                       bias, ctx.activation)
        return (dx if need_x else None, dw if need_w else None,
                db if need_b else None, None)


def conv_block_mc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  activation: str) -> torch.Tensor:
    """``act(conv(x) + b)`` for x (N, C, T, E), weight (C, C, kh, kw) of odd
    kh and kw and bias (C,), stride 1 and 'same' padding: one kernel
    forward, writing act'(z) only where autograd will need it, two
    backward."""
    x = x.contiguous()
    if torch.is_grad_enabled() and (
            x.requires_grad or weight.requires_grad or bias.requires_grad):
        return ConvBlockMCFunction.apply(x, weight, bias, activation)
    return conv_block_mc_fwd(x, weight, bias, activation)[0]
