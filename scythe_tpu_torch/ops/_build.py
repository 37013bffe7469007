"""Build the port's CUDA kernels at first use.

``load()`` compiles every ``ops/csrc/*.cu`` with nvcc for Hopper (sm_90a),
one nvcc per source, all started together, and links the objects into one
shared library with a plain C interface under ``scythe_tpu_torch/_build/``,
keyed by a hash of the sources and flags; it loads it with ctypes.  Nothing
is built when the package is imported: the CPU path never needs nvcc.  A
failed build raises with nvcc's output.

The Triton kernels (``ops/elementwise_probe.py``) compile at their first
launch; ``triton_cache_dir()`` points Triton's cache into the same
directory.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path

from .. import trace

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (
    *ARCH_FLAGS,
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers / shared memory / spills
)


@dataclass(frozen=True)
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # nvcc wall time (the span ops.build); 0.0 when reused
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


# scythe_column_solve_f32 / _f64: x, w, packed M, w_out, xi_out; ncols nz;
# the plan (ops/column_solve.py plan): RG KSLAB ST, threads, smem, blocks; stream
COLUMN_SOLVE_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
# scythe_column_solve_comp: the same but its plan (ops/column_solve.py
# plan_comp): SPAN NSPLIT RG NTW, threads, smem, blocks
COLUMN_SOLVE_COMP_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("scythe_column_solve_f32", "scythe_column_solve_f64"):
        fn = getattr(lib, name)
        fn.argtypes = COLUMN_SOLVE_ARGTYPES
        fn.restype = i32
    lib.scythe_column_solve_comp.argtypes = COLUMN_SOLVE_COMP_ARGTYPES
    lib.scythe_column_solve_comp.restype = i32
    for name in ("scythe_rlz_analysis_f32", "scythe_rlz_analysis_f64"):
        fn = getattr(lib, name)
        # x, l_analysis, ring_mask, analysis_r, analysis_z, out; V R L Z B;
        # the plan (ops/rlz_analysis.py): KT BT C RC LC ZC ST, threads, smem
        fn.argtypes = [ptr] * 6 + [i32] * 5 + [i32] * 9 + [ptr]
        fn.restype = i32
    # the comp mode: x, the packed l_analysis, ring_mask, the packed
    # analysis_r and analysis_z, out; V R L Z B and the packed operators'
    # variables; the comp plan: KT BT C RC RP LC ST, threads, smem
    lib.scythe_rlz_analysis_comp.argtypes = [ptr] * 6 + [i32] * 6 + [i32] * 9 + [ptr, ptr]
    lib.scythe_rlz_analysis_comp.restype = i32
    for name in (
        "scythe_column_solve_max_nz",
        "scythe_rlz_analysis_max_nz",
        "scythe_rlz_analysis_max_nl",
    ):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    lib.scythe_cuda_error_string.argtypes = [i32]
    lib.scythe_cuda_error_string.restype = ctypes.c_char_p


def _compile(sources: list[Path], path: Path) -> str:
    """nvcc -c for every source at once, then one link; returns the log."""
    nvcc = _nvcc()
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    procs = [
        (src, subprocess.Popen(
            [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
        for src, obj in zip(sources, objs)
    ]
    log, failed = "", []
    for src, proc in procs:
        out, _ = proc.communicate()
        log += f"== {src.name}\n{out}"
        if proc.returncode != 0:
            failed.append(src.name)
    if not failed:
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        log += link.stdout + link.stderr
        if link.returncode != 0:
            failed.append("link")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return log


_LOAD_LOCK = threading.Lock()


def load() -> Built:
    """Build (if needed) and load the kernel library; cached per process.
    Shards running as threads may reach a kernel at once: one builds, the
    others wait for it."""
    with _LOAD_LOCK:
        return _load()


@functools.cache
def _load() -> Built:
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    path = BUILD_DIR / f"libscythe_kernels_{h.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with trace.span("ops.build") as built:
            log = _compile(sources, path)
        seconds = built.seconds
    lib = ctypes.CDLL(str(path))
    _declare(lib)
    return Built(lib=lib, path=path, seconds=seconds, log=log)


def triton_cache_dir() -> str:
    """Point Triton's kernel cache into the build directory (before the
    first ``import triton``), so a run writes nothing outside the checkout."""
    cache = BUILD_DIR / "triton"
    cache.mkdir(parents=True, exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = str(cache)
    return str(cache)
