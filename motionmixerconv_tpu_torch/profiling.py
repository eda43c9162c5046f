"""Profiling and throughput observability on the card.

Counterpart of ``motionmixerconv_tpu/profiling.py``: the card's ceilings
(the one copy ``chip_smoke.py`` reads for its roofline bounds), the
physical-ceiling check, a ``torch.profiler`` trace context and the
throughput meter.

Trace a training run with ``MMC_PROFILE_DIR=/path``: the runners
(``cli/_runner.py``) trace the first epoch, or the first chunk of
``--epochs_per_dispatch`` epochs, into a Chrome/Perfetto trace JSON there.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np
import torch

# Per-card ceilings by torch.cuda.get_device_name(): NVIDIA's data sheet
# for the H100 SXM at its full 700 W (dense rates, no sparsity), not
# measurements. PEAK_FLOPS is the bf16 tensor-core rate; PEAK_FLOPS_F32 is
# float32 outside the tensor cores, since the port pins TF32 off
# (serving.resolve_device); PEAK_BYTES is the HBM3 rate. A card set below
# 700 W runs slower under load.
H100 = "NVIDIA H100 80GB HBM3"
PEAK_FLOPS = {H100: 989e12}
PEAK_FLOPS_F32 = {H100: 67e12}
PEAK_BYTES = {H100: 3.35e12}

# a byte count is a model of the traffic (each input read once, each
# output written once), so the bandwidth check allows this much headroom
# before it calls the timing broken; FLOP counts are exact, no slack there
_BYTES_CEILING_SLACK = 1.05


def peak_flops_for(device_kind: str, dtype) -> float | None:
    """Peak FLOP/s for ``device_kind`` at the given compute dtype: the
    tensor-core bf16 rate for 16-bit and narrower dtypes, the float32 rate
    for 32-bit ones, None for a kind with no table (the CPU). Wider dtypes
    raise: float64 has no table here, and checking it against a float32
    ceiling would pass an inflated measurement."""
    try:
        itemsize = np.dtype(dtype).itemsize
    except TypeError:  # "bfloat16", which numpy does not know
        itemsize = 2 if "16" in str(dtype) else 4
    if itemsize > 4:
        raise ValueError(
            f"no peak-FLOP/s ceiling for dtype {dtype!r} on {device_kind}; "
            "measure in f32/bf16 or add a bound")
    table = PEAK_FLOPS if itemsize <= 2 else PEAK_FLOPS_F32
    return table.get(device_kind)


def check_physical_ceilings(
    name: str,
    *,
    device_kind: str,
    dtype="float32",
    flops_per_s: float | None = None,
    bytes_per_s: float | None = None,
    strict_bytes: bool = True,
) -> bool:
    """Raise if a measurement implies more than the card can do.

    Achieved FLOP/s above the dtype's peak always raises: a FLOP count is
    exact, so only a broken timing gets there. Achieved bytes/s above the
    memory roof (with 5% slack) raises when ``strict_bytes``; otherwise
    the byte model may overcount (data a fused kernel keeps on chip), so
    the breach is reported and True returned. Unknown device kinds (the
    CPU) check nothing.

    Returns True if the bytes roof was breached but tolerated.
    """
    if flops_per_s is not None:
        peak = peak_flops_for(device_kind, dtype)
        if peak and flops_per_s > peak:
            raise RuntimeError(
                f"bench '{name}' implies {flops_per_s:.3g} FLOP/s > "
                f"{device_kind} {dtype} peak {peak:.3g} — timing or FLOP "
                f"accounting is broken")
    if bytes_per_s is not None:
        roof = PEAK_BYTES.get(device_kind)
        if roof and bytes_per_s > roof * _BYTES_CEILING_SLACK:
            if strict_bytes:
                raise RuntimeError(
                    f"bench '{name}' implies {bytes_per_s:.3g} HBM bytes/s > "
                    f"{device_kind} roof {roof:.3g} — timing or byte "
                    f"accounting is broken")
            print(f"# '{name}': modeled {bytes_per_s:.3g} B/s > roof "
                  f"{roof:.3g} — the byte model overcounts here; treating "
                  "bytes as an upper bound", file=sys.stderr)
            return True
    return False


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Trace the enclosed work with ``torch.profiler`` into a Chrome/
    Perfetto trace JSON, ``log_dir/trace_<pid>_<ns>.json`` (no-op for
    None): the host's activity, and the card's kernels and copies when
    torch sees a card."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    print(f"wrote the profiler trace {path}")


def profile_dir_from_env() -> str | None:
    return os.environ.get("MMC_PROFILE_DIR") or None


class ThroughputMeter:
    """Sequences/sec accounting across an epoch."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._n = 0
        self._t0 = time.perf_counter()

    def add(self, n_sequences: int) -> None:
        self._n += n_sequences

    @property
    def seq_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._n / dt if dt > 0 else 0.0
