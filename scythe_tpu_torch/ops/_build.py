"""Build the port's CUDA kernels at first use.

``load()`` compiles every ``ops/csrc/*.cu`` with nvcc for Hopper (sm_90a),
one nvcc per source, all started together, and links the objects into one
shared library with a plain C interface under ``scythe_tpu_torch/_build/``,
keyed by a hash of the sources and flags; it loads it with ctypes and
declares ``scythe_cuda_error_string``, the one entry point every kernel
shares.  Each ops module declares its own kernels' entry points beside the
calls whose argument order they describe.  Nothing is built when the
package is imported: the CPU path never needs nvcc.  A failed build raises
with nvcc's output.

``load_host()`` compiles the host code, ``ops/csrc/*.cpp`` (the CSV
writer), with the host C++ compiler into a library of its own in the same
directory, keyed the same way; without a compiler it returns None and
``io`` writes with numpy.

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


def _declare(lib: ctypes.CDLL) -> None:
    lib.scythe_cuda_error_string.argtypes = [ctypes.c_int]
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


HOST_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared")


def _declare_host(lib: ctypes.CDLL) -> None:
    # path, header, its length, the rows' float64 values, nrows, ncols -> errno
    lib.scythe_write_csv.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_longlong,
                                     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
    lib.scythe_write_csv.restype = ctypes.c_int


def load_host() -> ctypes.CDLL | None:
    """Build (if needed) and load the host library; None where no host C++
    compiler is found.  Cached per process."""
    with _LOAD_LOCK:
        return _load_host()


@functools.cache
def _load_host() -> ctypes.CDLL | None:
    sources = sorted(CSRC.glob("*.cpp"))
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    path = BUILD_DIR / f"libscythe_host_{h.hexdigest()[:16]}.so"
    if not path.exists():
        cxx = shutil.which("c++") or shutil.which("g++")
        if cxx is None:
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        done = subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp), *map(str, sources)],
                              capture_output=True, text=True)
        if done.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cxx} failed:\n{done.stdout}{done.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    _declare_host(lib)
    return lib


def triton_cache_dir() -> str:
    """Point Triton's kernel cache into the build directory (before the
    first ``import triton``), so a run writes nothing outside the checkout."""
    cache = BUILD_DIR / "triton"
    cache.mkdir(parents=True, exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = str(cache)
    return str(cache)
