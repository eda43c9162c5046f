"""The single-channel ConvBlock (conv -> bias -> activation) as one CUDA
kernel each way: the wrappers, their autograd Function and their plain
PyTorch versions.

``ConvBlock`` (``models/mixer_conv.py``) of one channel, at stride 1 with
'same' padding and no compute dtype, computes ``a = act(conv(x) + b)``
through ``conv_block`` on float32 CUDA tensors. The kernels
(``csrc/conv_block.cu``) take the place of cuDNN's convolution, its bias
and weight gradients and the activation's eager chain (about 28 kernels a
block and a training step, inside the step's CUDA graph) with one forward
and one backward launch. They replace no TPU kernel: in the JAX package
XLA fused this chain and no Pallas kernel stood for it. A call moves about
0.2 MB at the flagship's shapes, so launch latency bounds it.

The forward saves only its input: the backward recomputes ``z`` from the
taps. The backward's weight and bias gradients are sums over the batch; its
last block adds every block's partial sums in a fixed order, counted in an
int of the call's own, which the call's forward zeroes: two launches give
identical bits, and concurrent calls share no scratch.

The plain versions are today's composition ``F.conv2d`` + bias + the
activation, and autograd's gradient of it; the wrappers take them only for
CPU tensors. A CUDA tensor the kernels do not take (another dtype, or a
plane too large for a block's shared memory) raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import Counter, check, load_library, stream_ptr
from .activations import get_activation

LAUNCHES = Counter()      # forward kernel launches (CUDA tensors)
LAUNCHES_BWD = Counter()  # backward kernel launches (CUDA tensors)
PLAIN_CALLS = Counter()   # forward or backward calls served by a plain
                          # version (CPU tensors)

ACTIVATIONS = ("gelu", "mish")  # the kernels' activation index
PLANE_TOO_LARGE = -1  # an entry's return where a block's planes exceed its
                      # shared memory (csrc/conv_block.cu kPlaneTooLarge)


def takes(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """Whether the kernels compute ``conv_block`` on ``x`` (N, 1, T, E) with
    ``weight`` (1, 1, kh, kw): float32 tensors on a CUDA device. The
    kernels raise where they cannot; nothing on the card falls back."""
    return (x.is_cuda and x.dtype == torch.float32
            and weight.dtype == torch.float32)


def device_launches() -> tuple:
    """(forward, backward) kernel launches the current CUDA device has run
    since the library was loaded, as the kernels count them on the device:
    replays of a captured CUDA graph included, which ``LAUNCHES`` and
    ``LAUNCHES_BWD`` (counted where a wrapper launches) cannot see. Waits
    for the device; callers read differences."""
    lib = load_library()
    out = (ctypes.c_ulonglong * 2)()
    torch.cuda.synchronize()
    check(lib, lib.mmc_conv_block_device_launches(ctypes.addressof(out)),
          "conv_block kernels' device launch counts")
    return int(out[0]), int(out[1])


def conv_block_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, activation: str) -> torch.Tensor:
    """The forward kernel's function in plain torch: ``ConvBlock``'s own
    composition, conv with 'same' padding and the bias, then the
    activation."""
    return get_activation(activation)(F.conv2d(x, weight, bias,
                                               padding="same"))


def conv_block_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                         weight: torch.Tensor, bias: torch.Tensor,
                         activation: str):
    """The backward kernel's function in plain torch: (dx, dw, db) for the
    upstream gradient ``g`` of ``a``, autograd's through
    ``conv_block_plain``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, weight, bias)]
        return torch.autograd.grad(
            conv_block_plain(*leaves, activation), leaves, g)


def _check_args(x, weight, bias, activation, *more):
    """Validate what both kernels take; returns (N, T, E, kh, kw)."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"Unknown activation function type: {activation}")
    if x.dim() != 4 or x.shape[1] != 1 or weight.dim() != 4 \
            or tuple(weight.shape[:2]) != (1, 1) or tuple(bias.shape) != (1,):
        raise ValueError(
            "conv_block takes x (N, 1, T, E), weight (1, 1, kh, kw) and bias "
            f"(1,), got {tuple(x.shape)}, {tuple(weight.shape)} and "
            f"{tuple(bias.shape)}")
    for t in (x, weight, bias, *more):
        if t.device != x.device:
            raise ValueError("conv_block: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError("conv_block takes contiguous tensors")
    n, _, t, e = x.shape
    return n, t, e, weight.shape[2], weight.shape[3]


def _check_cuda(x, weight, *more):
    """Refuse CUDA tensors the kernels do not take."""
    if x.device.type != "cuda":
        raise RuntimeError(f"conv_block: no kernel for {x.device}")
    for t in (x, weight, *more):
        if t.dtype != torch.float32:
            raise TypeError("conv_block's kernels take float32 tensors")


def _check_launch(lib, err: int, what: str, x, weight) -> None:
    """Raise if a launch failed: NotImplementedError where the planes exceed
    a block's shared memory."""
    if err == PLANE_TOO_LARGE:
        raise NotImplementedError(
            f"{what}: a plane of {tuple(x.shape[-2:])} with taps "
            f"{tuple(weight.shape[-2:])} exceeds the kernel's shared memory")
    check(lib, err, what)


def conv_block_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   activation: str, counter=None) -> torch.Tensor:
    """a = act(conv(x) + b), (N, 1, T, E): the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors, an error otherwise. ``counter``, one
    int32 of the call's own on the device (or None where no backward
    follows), is zeroed for ``conv_block_bwd``."""
    n, t, e, kh, kw = _check_args(x, weight, bias, activation)
    if x.device.type == "cpu":
        PLAIN_CALLS.add()
        return conv_block_plain(x, weight, bias, activation)
    _check_cuda(x, weight, bias)
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.mmc_conv_block_fwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            counter.data_ptr() if counter is not None else None, n, t, e, kh,
            kw, ACTIVATIONS.index(activation), stream_ptr(x.device))
    _check_launch(lib, err, "conv_block_fwd", x, weight)
    LAUNCHES.add()
    return out


def conv_block_bwd(x: torch.Tensor, g: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, activation: str, counter=None):
    """(dx, dw, db) for the upstream gradient ``g`` (N, 1, T, E): the CUDA
    kernel for CUDA tensors, with the ``counter`` the call's forward zeroed,
    the plain version for CPU tensors, an error otherwise."""
    n, t, e, kh, kw = _check_args(x, weight, bias, activation, g)
    if tuple(g.shape) != tuple(x.shape):
        raise ValueError(f"expected g {tuple(x.shape)}, got {tuple(g.shape)}")
    if x.device.type == "cpu":
        PLAIN_CALLS.add()
        return conv_block_bwd_plain(x, g, weight, bias, activation)
    _check_cuda(x, weight, bias, g)
    dx, dw, db = (torch.empty_like(x), torch.empty_like(weight),
                  torch.empty_like(bias))
    if n == 0:
        return dx, dw.zero_(), db.zero_()
    if counter is None or counter.dtype != torch.int32 \
            or counter.device != x.device:
        raise ValueError("conv_block_bwd needs the int32 counter its forward "
                         "zeroed, on the same device")
    part = torch.empty(n * (kh * kw + 1), device=x.device,
                       dtype=torch.float32)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.mmc_conv_block_bwd(
            x.data_ptr(), g.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), db.data_ptr(), part.data_ptr(),
            counter.data_ptr(), n, t, e, kh, kw,
            ACTIVATIONS.index(activation), stream_ptr(x.device))
    _check_launch(lib, err, "conv_block_bwd", x, weight)
    LAUNCHES_BWD.add()
    return dx, dw, db


class ConvBlockFunction(torch.autograd.Function):
    """Forward and backward through the kernels (on the CPU, through their
    plain versions). ``activation`` and ``counter`` take no gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, activation, counter):
        ctx.activation = activation
        ctx.save_for_backward(x, weight, bias, counter)
        return conv_block_fwd(x, weight, bias, activation, counter)

    @staticmethod
    def backward(ctx, grad_out):
        x, weight, bias, counter = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx, dw, db = conv_block_bwd(x, grad_out.contiguous(), weight, bias,
                                    ctx.activation, counter)
        return (dx if need_x else None, dw if need_w else None,
                db if need_b else None, None, None)


def conv_block(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               activation: str) -> torch.Tensor:
    """``act(conv(x) + b)`` for x (N, 1, T, E), weight (1, 1, kh, kw) and
    bias (1,), stride 1 and 'same' padding, as one kernel each way."""
    x = x.contiguous()
    counter = None
    if x.is_cuda and torch.is_grad_enabled() and (
            x.requires_grad or weight.requires_grad or bias.requires_grad):
        counter = torch.empty(1, device=x.device, dtype=torch.int32)
    return ConvBlockFunction.apply(x, weight, bias, activation, counter)
