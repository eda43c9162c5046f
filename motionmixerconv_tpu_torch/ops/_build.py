"""Build and load the hand-written CUDA kernels at first use.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc``, all
started together, and the objects are linked into one shared library with
a plain C interface, loaded with ``ctypes``; no source includes PyTorch's
headers. The library lands in ``build/torch_kernels/`` at the repository
root (listed in ``.gitignore``), named by a hash of the sources and flags,
so an unchanged tree reuses it and a changed one rebuilds. A failed build
raises; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

MAX_SMEM_BYTES = 232448  # dynamic shared memory one H100 block can use
SM_SMEM_BYTES = 233472   # shared memory of one H100 SM


def slices(n: int, K: int):
    """(first, width) of each of K contiguous slices of n columns, the first
    n % K one wider: how a cluster's blocks split a width
    (``csrc/cluster.cuh`` slice_start, slice_width)."""
    base, extra = divmod(n, K)
    return [(r * base + min(r, extra), base + (r < extra)) for r in range(K)]


_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output of the last build in this process (ptxas -v)


class Counter:
    """A thread-safe integer count (kernel launches, plain-version calls)."""

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.value += 1

    def reset(self) -> None:
        with self._lock:
            self.value = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _run_all(cmds) -> str:
    """Start every command at once, wait for all; raise if any failed.
    Returns their output, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out}")
    return "".join(outs)


def _compile(lib_path: Path) -> str:
    """Every source into ``lib_path``: one nvcc per source, all started
    together, then one link; returns their log."""
    nvcc = _nvcc()
    tmp = lib_path.with_name(f".{lib_path.name}.{os.getpid()}")
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in srcs]
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                        for src, o in zip(srcs, objs)])
        log += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                          *map(str, objs)]])
        os.replace(tmp, lib_path)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return log


def _declare(lib) -> None:
    p, i, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.mmc_error_string.argtypes = [i]
    lib.mmc_error_string.restype = ctypes.c_char_p
    lib.mmc_conv_mixer_weights_numel.argtypes = [i] * 10
    lib.mmc_conv_mixer_weights_numel.restype = L
    lib.mmc_conv_mixer_smem_bytes.argtypes = [i] * 10
    lib.mmc_conv_mixer_smem_bytes.restype = L
    lib.mmc_conv_mixer_card_smem.argtypes = []
    lib.mmc_conv_mixer_card_smem.restype = i
    lib.mmc_conv_mixer_resident_blocks.argtypes = [i, L]
    lib.mmc_conv_mixer_resident_blocks.restype = i
    lib.mmc_conv_mixer_fused.argtypes = [p, p, p] + [i] * 16 + [p]
    lib.mmc_conv_mixer_fused.restype = i
    lib.mmc_conv_mixer_mc_weights_numel.argtypes = [i] * 11
    lib.mmc_conv_mixer_mc_weights_numel.restype = L
    lib.mmc_conv_mixer_mc_smem_bytes.argtypes = [i] * 12
    lib.mmc_conv_mixer_mc_smem_bytes.restype = L
    lib.mmc_conv_mixer_mc_max_clusters.argtypes = [i] * 3
    lib.mmc_conv_mixer_mc_max_clusters.restype = i
    lib.mmc_conv_mixer_mc.argtypes = [p, p, p] + [i] * 19 + [p]
    lib.mmc_conv_mixer_mc.restype = i
    lib.mmc_mlp_mixer.argtypes = [p] * 4 + [i] * 19 + [p]
    lib.mmc_mlp_mixer.restype = i
    for name in ("fwd_rows", "fwd_max_cols", "dw_rows", "dx_rows"):
        getattr(lib, f"mmc_harmonic_{name}").argtypes = []
        getattr(lib, f"mmc_harmonic_{name}").restype = i
    for name, n_args in (("fwd", 2), ("dw", 2), ("finish", 2), ("dx", 3)):
        getattr(lib, f"mmc_harmonic_{name}_smem_bytes").argtypes = [i] * n_args
        getattr(lib, f"mmc_harmonic_{name}_smem_bytes").restype = L
    lib.mmc_harmonic_device_launches.argtypes = [p]
    lib.mmc_harmonic_device_launches.restype = i
    lib.mmc_harmonic_resident_blocks.argtypes = [i, i, L]
    lib.mmc_harmonic_resident_blocks.restype = i
    lib.mmc_harmonic_dense_fwd.argtypes = [p] * 6 + [i] * 8 + [p]
    lib.mmc_harmonic_dense_fwd.restype = i
    lib.mmc_harmonic_dense_bwd.argtypes = [p] * 8 + [i] * 11 + [p]
    lib.mmc_harmonic_dense_bwd.restype = i


def load_library():
    """The kernels' shared library, built on first call. Needs a CUDA card
    and ``nvcc``; raises RuntimeError otherwise."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the CUDA kernels cannot run")
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in sorted(CSRC.iterdir()):
            h.update(f.name.encode())
            h.update(f.read_bytes())
        lib_path = BUILD_DIR / f"libmmc_kernels_{h.hexdigest()[:16]}.so"
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # one builder at a time across processes; the others wait, then load
        with open(BUILD_DIR / ".lock", "w") as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_EX)
            try:
                if not lib_path.exists():
                    build_log = _compile(lib_path)
            finally:
                fcntl.flock(lock_file, fcntl.LOCK_UN)
        lib = ctypes.CDLL(str(lib_path))
        _declare(lib)
        _lib = lib
        return lib


def check(lib, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(
            f"{what}: CUDA error {err}: {lib.mmc_error_string(err).decode()}")


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device`` as a raw pointer."""
    return torch.cuda.current_stream(device).cuda_stream
