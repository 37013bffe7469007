"""The port's CSV writer (``io._write_csv`` through ``ops/csrc/csv_writer.cpp``,
built by ``ops._build.load_host``) on the CPU.

* Its bytes are the header line, then each row's values as C's ``%.17g``
  (Python's ``%`` gives the same text), comma-joined: those of
  ``scythe_native_io.write_csv``, which the JAX package writes with, and of
  the numpy fallback the port takes without a host compiler.
* It releases the GIL: a Python thread runs while it writes 2e6 rows.
* A file it cannot open or write raises OSError with the errno's type.
"""

import os
import threading
import time

import numpy as np
import pytest

from scythe_tpu_torch import io as sio
from scythe_tpu_torch.ops import _build

_CASES = {
    "small": np.array([[1.0, 2.5], [3.0, -4.25], [1e-17, 1.23456789012345678]]),
    "scaled": (np.random.default_rng(0).normal(size=(257, 5))
               * 10.0 ** np.random.default_rng(0).integers(-10, 10, size=(257, 5))),
    "two_by_two": np.array([[0.1, 2.0], [3.0, 4.0]]),
    "edges": np.array([[-0.0, 0.0, 5e-324, 1.7976931348623157e308, -np.inf, np.inf, np.nan]]),
    "strided": np.arange(24.0).reshape(4, 6)[:, ::2] / 7.0,
}


@pytest.fixture(scope="module")
def host():
    lib = _build.load_host()
    assert lib is not None, "no host C++ compiler: the port's CSV writer was not built"
    return lib


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("case", sorted(_CASES))
def test_the_bytes_are_the_17g_text(case, tmp_path, host):
    cols = _CASES[case]
    names = [f"c{j}" for j in range(cols.shape[1])]
    path = str(tmp_path / "t.csv")
    sio._write_csv(path, names, cols)
    text = ",".join(names) + "\n" + "".join(
        ",".join("%.17g" % x for x in row) + "\n" for row in cols)
    assert _read(path) == text.encode()


@pytest.mark.skipif(sio._nio is None, reason="scythe_native_io not built")
@pytest.mark.parametrize("case", sorted(_CASES))
def test_the_bytes_are_the_native_modules(case, tmp_path, host, monkeypatch):
    """The same file from the port's writer, from ``scythe_native_io`` and
    from the port's numpy fallback where no host compiler is found."""
    cols = _CASES[case]
    names = [f"c{j}" for j in range(cols.shape[1])]
    sio._write_csv(str(tmp_path / "port.csv"), names, cols)
    arr = np.ascontiguousarray(cols, np.float64)
    sio._nio.write_csv(str(tmp_path / "native.csv"), names, arr.data, *arr.shape)
    monkeypatch.setattr(_build, "load_host", lambda: None)
    sio._write_csv(str(tmp_path / "fallback.csv"), names, cols)
    port = _read(tmp_path / "port.csv")
    assert port == _read(tmp_path / "native.csv") == _read(tmp_path / "fallback.csv")


def test_the_write_releases_the_gil(tmp_path, host):
    """A Python thread stamps the clock in the middle 80% of a 2e6-row
    write; holding the GIL through the write, it could not run there."""
    cols = np.random.default_rng(1).normal(size=(2_000_000, 1))
    stamps, stop, running = [], threading.Event(), threading.Event()

    def spin():
        n = 0
        running.set()
        while not stop.is_set():
            n += 1
            if n % 1000 == 0:
                stamps.append(time.perf_counter())

    th = threading.Thread(target=spin)
    th.start()
    running.wait()
    try:
        t0 = time.perf_counter()
        sio._write_csv(str(tmp_path / "big.csv"), ["u"], cols)
        t1 = time.perf_counter()
    finally:
        stop.set()
        th.join()
    lo, hi = t0 + 0.1 * (t1 - t0), t1 - 0.1 * (t1 - t0)
    assert sum(lo < s < hi for s in stamps) >= 10, (t1 - t0, len(stamps))
    assert os.path.getsize(tmp_path / "big.csv") > 2_000_000 * 10


def test_a_file_it_cannot_open_raises_with_its_errno(tmp_path, host):
    with pytest.raises(FileNotFoundError):
        sio._write_csv(str(tmp_path / "no" / "t.csv"), ["a"], np.zeros((1, 1)))
    with pytest.raises(TypeError):
        sio._write_csv(str(tmp_path / "t.csv"), ["a", 3], np.zeros((1, 2)))


@pytest.mark.skipif(not os.path.exists("/dev/full"), reason="no /dev/full device")
def test_a_write_that_fails_raises(host):
    with pytest.raises(OSError) as err:
        sio._write_csv("/dev/full", ["a"], np.zeros((100_000, 1)))
    assert err.value.errno is not None and err.value.errno != 0
