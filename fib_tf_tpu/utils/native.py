"""ctypes bindings to the native table toolchain.

The reference's native components are a CUDA/C++ lookup-table pipeline
(generate_table + init_table).  Here the equivalents live in
fib_tf_tpu/native/ (rates.h, generate_table.cpp, table_lib.cpp); this
module builds them on demand with `make` and binds libfibtable.so via
ctypes (no pybind11 in the image).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from typing import Optional

import numpy as np

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
_LIB: Optional[ctypes.CDLL] = None


def build() -> str:
    """Build the native toolchain from its committed sources with make
    (incremental, so a no-op when up to date); returns the .so path.
    A file lock serializes concurrent callers (parallel test workers),
    which would otherwise race on the same outputs."""
    with open(os.path.join(NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(["make", "-C", NATIVE_DIR], check=True,
                       capture_output=True)
    return os.path.join(NATIVE_DIR, "libfibtable.so")


def executable(name: str) -> str:
    """Path of a native 0D simulator (`cell_sim`, `cell_sim_fb`), built
    first."""
    build()
    return os.path.join(NATIVE_DIR, name)


def load() -> ctypes.CDLL:
    """Load (building if needed) the native library."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        lib.fib_table_rows.restype = ctypes.c_int
        lib.fib_table_cols.restype = ctypes.c_int
        lib.fib_init_table.argtypes = [
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        ]
        lib.fib_calc_inter.argtypes = [
            ctypes.c_double,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        _LIB = lib
    return _LIB


def native_available() -> bool:
    try:
        load()
        return True
    except (OSError, subprocess.CalledProcessError, FileNotFoundError):
        return False


def native_table() -> np.ndarray:
    """The 150x30 Courtemanche rate table from the C++ generator
    (equivalent of the reference's init_table path)."""
    lib = load()
    rows, cols = lib.fib_table_rows(), lib.fib_table_cols()
    out = np.empty((rows, cols), dtype=np.float32)
    lib.fib_init_table(out.reshape(-1))
    return out


def native_intermediates(v: float) -> np.ndarray:
    """The 30 intermediates at one voltage (golden-value path)."""
    lib = load()
    out = np.empty(30, dtype=np.float64)
    lib.fib_calc_inter(float(v), out)
    return out
