"""Build the port's CUDA kernels at first use.

``load()`` compiles every ``ops/csrc/*.cu`` with nvcc for Hopper (sm_90a)
into one shared library with a plain C interface under
``scythe_tpu_torch/_build/``, keyed by a hash of the sources and flags, and
loads it with ctypes.  Nothing is built when the package is imported: the
CPU path never needs nvcc.  A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers / shared memory / spills
)


@dataclass(frozen=True)
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # nvcc wall time; 0.0 when a built library was reused
    log: str  # nvcc's output (ptxas resource usage), empty when reused


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels of scythe_tpu_torch are built from ops/csrc at first use"
        )
    return found


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("scythe_column_solve_f32", "scythe_column_solve_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 9 + [i32, i32, f64, f64, ptr]
        fn.restype = i32
    lib.scythe_column_solve_max_nz.argtypes = []
    lib.scythe_column_solve_max_nz.restype = i32
    lib.scythe_cuda_error_string.argtypes = [i32]
    lib.scythe_cuda_error_string.restype = ctypes.c_char_p


@functools.cache
def load() -> Built:
    """Build (if needed) and load the kernel library; cached per process."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    path = BUILD_DIR / f"libscythe_kernels_{h.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}"
            )
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    lib = ctypes.CDLL(str(path))
    _declare(lib)
    return Built(lib=lib, path=path, seconds=seconds, log=log)
