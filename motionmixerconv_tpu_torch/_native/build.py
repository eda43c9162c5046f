"""Build and load the native CSV reader at first use.

``csv_reader.cpp`` is compiled with ``g++ -O3 -shared -fPIC`` into
``build/native/`` at the repository root (listed in ``.gitignore``), named
by a hash of the source and flags, and loaded with ``ctypes``. Processes
that build at once from a cold directory take turns under an ``fcntl``
lock, and each compiles into a file of its own that ``os.replace`` moves
into place, so no build can clobber another. A failed build raises with
the compiler's output: the reader never falls back to numpy in its place,
so a corpus's bits do not depend on whether a build succeeded.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "csv_reader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _compile(so_path: Path) -> None:
    tmp = so_path.with_name(f".{so_path.name}.{os.getpid()}")
    try:
        try:
            r = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                               capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(
                f"g++ not found: the native CSV reader cannot be built ({e})"
            ) from e
        if r.returncode != 0:
            raise RuntimeError(
                f"g++ failed to build the native CSV reader (exit "
                f"{r.returncode}):\n{r.stderr}{r.stdout}")
        os.replace(tmp, so_path)
    finally:
        tmp.unlink(missing_ok=True)


def _declare(lib: ctypes.CDLL) -> None:
    f_p, L_p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_long)
    lib.mmc_read_csv.restype = f_p
    lib.mmc_read_csv.argtypes = [ctypes.c_char_p, L_p, L_p]
    lib.mmc_read_csv_many.restype = ctypes.c_int
    lib.mmc_read_csv_many.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                      ctypes.c_int, L_p, L_p,
                                      ctypes.POINTER(f_p)]
    lib.mmc_free.argtypes = [f_p]
    lib.mmc_free.restype = None


def load_csv_reader() -> ctypes.CDLL:
    """The reader's shared library, built on the first call in
    ``BUILD_DIR``; RuntimeError with the compiler's output if it cannot be
    built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
        h.update(SRC.read_bytes())
        so_path = BUILD_DIR / f"csv_reader_{h.hexdigest()[:16]}.so"
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # one build at a time across processes; the others wait, then load
        with open(BUILD_DIR / ".lock", "w") as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_EX)
            try:
                if not so_path.exists():
                    _compile(so_path)
            finally:
                fcntl.flock(lock_file, fcntl.LOCK_UN)
        lib = ctypes.CDLL(str(so_path))
        _declare(lib)
        _lib = lib
        return lib


def _take(lib: ctypes.CDLL, ptr, rows: int, cols: int) -> np.ndarray:
    """A (rows, cols) float32 copy of a buffer the library returned; frees
    it."""
    try:
        flat = np.ctypeslib.as_array(ptr, shape=(rows * cols,))
        return flat.astype(np.float32, copy=True).reshape(rows, cols)
    finally:
        lib.mmc_free(ptr)


def read_csv_many_native(paths: list[str]) -> list[Optional[np.ndarray]]:
    """Parse many CSV files concurrently on a native thread pool. Returns
    a list aligned with ``paths``: None for a file that is missing, empty,
    ragged or holds a field that is not a number."""
    lib = load_csv_reader()
    n = len(paths)
    if n == 0:
        return []
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    rows = (ctypes.c_long * n)()
    cols = (ctypes.c_long * n)()
    ptrs = (ctypes.POINTER(ctypes.c_float) * n)()
    lib.mmc_read_csv_many(c_paths, n, rows, cols, ptrs)
    return [_take(lib, ptrs[i], rows[i], cols[i]) if ptrs[i] else None
            for i in range(n)]


def read_csv_native(path: str) -> Optional[np.ndarray]:
    """Parse one CSV float matrix; None for a file that is missing, empty,
    ragged or holds a field that is not a number."""
    lib = load_csv_reader()
    rows, cols = ctypes.c_long(), ctypes.c_long()
    ptr = lib.mmc_read_csv(os.fsencode(path), ctypes.byref(rows),
                           ctypes.byref(cols))
    if not ptr:
        return None
    return _take(lib, ptr, rows.value, cols.value)
