"""Adam's update of a training step's parameters as one CUDA kernel: the
wrapper and its plain PyTorch version.

``train/optim.py`` ``Optimizer.update`` calls ``adam_update`` on a CUDA
device with the tensors of ``torch.optim.Adam``'s own state (created in its
capturable format), so the state keeps torch's form for checkpoints. The
kernel (``csrc/adam.cu``) takes the place of torch's capturable
multi-tensor Adam, which makes about 2N + 21 launches a step for N tensors
(two broadcast divisions a tensor among them), with one launch. It replaces
no TPU kernel: in the JAX package optax's Adam was XLA's to fuse. It moves
28 bytes an element, so launch latency bounds it.

Every element takes the float32 operations of torch's capturable branch in
their order and rounding: the coupled L2 term, the moments (lerp; scale
and add of the squared gradient), the bias corrections from the device
step count ``b1^t - 1`` over lr, reciprocated, and ``sqrt(1 - b2^t)``, then
``p + m / ((sqrt(v) / bc2 + eps) / step_size)``. The step counts advance
by one each. The kernel counts its last block in ``counter``, one int32 of
the caller's own that it leaves at 0, so concurrent optimizers share no
scratch and a captured graph replays the launch as it is.

The plain version repeats that arithmetic with torch operations; the
wrapper takes it only for CPU tensors. A CUDA tensor the kernel does not
take raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ._build import Counter, check, load_library, stream_ptr

LAUNCHES = Counter()     # kernel launches (CUDA tensors)
PLAIN_CALLS = Counter()  # calls served by the plain version (CPU tensors)


def refusal(param: torch.Tensor, grad: torch.Tensor) -> Optional[str]:
    """Why the kernel does not take ``param`` with its ``grad``, or None
    where it does: both float32, dense, contiguous and on one device."""
    if grad.is_sparse:
        return "a sparse gradient"
    if param.dtype != torch.float32 or grad.dtype != torch.float32:
        return f"{param.dtype} with a {grad.dtype} gradient, not float32"
    if grad.device != param.device:
        return f"its gradient on {grad.device}, not {param.device}"
    if tuple(grad.shape) != tuple(param.shape):
        return f"a gradient of shape {tuple(grad.shape)}"
    if not (param.is_contiguous() and grad.is_contiguous()):
        return "not contiguous"
    return None


def device_launches() -> int:
    """Kernel launches the current CUDA device has run since the library
    was loaded, as the kernel counts them on the device: replays of a
    captured CUDA graph included, which ``LAUNCHES`` (counted where the
    wrapper launches) cannot see. Waits for the device; callers read
    differences."""
    lib = load_library()
    out = ctypes.c_ulonglong()
    torch.cuda.synchronize()
    check(lib, lib.mmc_adam_device_launches(ctypes.byref(out)),
          "adam kernel's device launch count")
    return int(out.value)


def adam_update_plain(params, grads, exp_avgs, exp_avg_sqs, steps, lr,
                      beta1: float, beta2: float, eps: float,
                      weight_decay: float) -> None:
    """The kernel's function in plain torch, in place: torch's capturable
    Adam step, a tensor at a time."""
    with torch.no_grad():
        for p, g, m, v, step in zip(params, grads, exp_avgs, exp_avg_sqs,
                                    steps):
            step.add_(1)
            if weight_decay != 0:
                g = g.add(p, alpha=weight_decay)
            m.lerp_(g, 1 - beta1)
            v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
            bc1 = torch.pow(beta1, step).sub_(1).div_(lr).reciprocal_()
            bc2 = torch.pow(beta2, step).sub_(1).neg_().sqrt_()
            p.addcdiv_(m, v.sqrt().div_(bc2).add_(eps).div_(bc1))


def _check(params, grads, exp_avgs, exp_avg_sqs, steps, lr, counter):
    """Refuse what the kernel does not take, naming the tensor."""
    dev = params[0].device
    for i, (p, g, m, v, s) in enumerate(zip(params, grads, exp_avgs,
                                            exp_avg_sqs, steps)):
        why = refusal(p, g)
        for name, t in (("exp_avg", m), ("exp_avg_sq", v)):
            if why is None and (t.dtype != torch.float32 or t.device != dev
                                or tuple(t.shape) != tuple(p.shape)
                                or not t.is_contiguous()):
                why = f"its {name} is not a contiguous float32 like it"
        if why is None and p.device != dev:
            why = f"on {p.device}, not {dev}"
        if why is None and (s.dtype != torch.float32 or s.device != dev
                            or s.numel() != 1):
            why = "its step is not one float32 on its device"
        if why is not None:
            raise NotImplementedError(
                f"adam_update: no kernel for tensor {i} of shape "
                f"{tuple(p.shape)}: {why}")
    for name, t, dtype in (("lr", lr, torch.float32),
                           ("counter", counter, torch.int32)):
        if not isinstance(t, torch.Tensor) or t.dtype != dtype \
                or t.device != dev or t.numel() != 1:
            raise ValueError(f"adam_update's {name} must be one {dtype} on "
                             f"{dev}")


def adam_update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                exp_avgs: Sequence[torch.Tensor],
                exp_avg_sqs: Sequence[torch.Tensor],
                steps: Sequence[torch.Tensor], lr, beta1: float,
                beta2: float, eps: float, weight_decay: float,
                counter: Optional[torch.Tensor]) -> None:
    """One Adam step with coupled L2 of every ``params[i]``, in place, from
    ``grads[i]``, the moments ``exp_avgs[i]``, ``exp_avg_sqs[i]`` and the
    count ``steps[i]`` (a 0-dim float32, advanced by one): the CUDA kernel
    for CUDA tensors (``lr`` a float32 device scalar, ``counter`` one int32
    of the caller's own at 0), the plain version for CPU tensors (``lr`` a
    float or a tensor; ``counter`` unused), an error otherwise."""
    lists = (params, grads, exp_avgs, exp_avg_sqs, steps)
    n = len(params)
    if any(len(x) != n for x in lists):
        raise ValueError("adam_update takes lists of one length")
    if n == 0:
        return
    dev = params[0].device
    if dev.type == "cpu":
        PLAIN_CALLS.add()
        adam_update_plain(*lists, lr, beta1, beta2, eps, weight_decay)
        return
    if dev.type != "cuda":
        raise RuntimeError(f"adam_update: no kernel for {dev}")
    _check(*lists, lr, counter)
    lib = load_library()
    width = lib.mmc_adam_max_tensors()
    with torch.cuda.device(dev):
        for lo in range(0, n, width):
            part = [x[lo:lo + width] for x in lists]
            k = len(part[0])
            ptrs = [(ctypes.c_void_p * k)(*[t.data_ptr() for t in x])
                    for x in part]
            numels = (ctypes.c_longlong * k)(*[p.numel() for p in part[0]])
            err = lib.mmc_adam(*ptrs, numels, k, lr.data_ptr(), beta1, beta2,
                               eps, weight_decay, counter.data_ptr(),
                               stream_ptr(dev))
            check(lib, err, "adam_update")
            LAUNCHES.add()
    # the kernel wrote in place behind autograd's back, as torch's own
    # in-place update would have told it
    torch.autograd.graph.increment_version(
        [t for x in (params, exp_avgs, exp_avg_sqs, steps) for t in x])
