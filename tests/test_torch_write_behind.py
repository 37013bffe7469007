"""The run loop's write-behind output boundary (``model.run_loop``,
``model._WriteBehind``) on the CPU, on the flagship at 8 cells x 16: four
intervals of three steps, five outputs.

* Overlap: a write that blocks until the next interval has started lets
  the run go on (a synchronous loop would never start it: the write fails
  after 10 s).
* The files are those of a synchronous loop that calls
  ``io.write_output`` and ``io.write_spectral`` at each boundary: the same
  names, bytes and order.
* The spectral file holds the coefficients of its boundary even when the
  next interval overwrites the state's tensors before the write runs.
* A write's exception leaves ``run_loop`` with its own type, from the
  first write (at the next hand-off) and from the last (at the end).
* The NaN watchdog raises at the boundary where the fields turn
  non-finite, after the writes before it are on disk; where the write
  still pending there fails, the watchdog's error is the one raised, with
  the write's in a note.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from scythe_tpu_torch import io as sio
from scythe_tpu_torch import model as tmodel

from test_torch_trace import F64, _flagship_run

N_INT, STEPS, OUT_S = 4, 3, 9.0  # the flagship run of _flagship_run's defaults


def _index(t):
    return int(round(t / OUT_S))


class _Intervals:
    """``model.make_scan`` counting the intervals that started and ended;
    ``after(state, out)`` runs on each interval's result before it is
    returned."""

    def __init__(self, monkeypatch, after=None):
        self.started = self.ended = 0
        self.cond = threading.Condition()
        self.after = after
        real = tmodel.make_scan

        def make_scan(step, n):
            chunk = real(step, n)

            def run(state):
                with self.cond:
                    self.started += 1
                    self.cond.notify_all()
                out = chunk(state)
                if self.after is not None:
                    out = self.after(state, out)
                with self.cond:
                    self.ended += 1
                    self.cond.notify_all()
                return out

            return run

        monkeypatch.setattr(tmodel, "make_scan", make_scan)

    def wait(self, what, k):
        """Wait until more than ``k`` intervals have ``what`` (10 s)."""
        with self.cond:
            if not self.cond.wait_for(lambda: getattr(self, what) > k, timeout=10.0):
                raise AssertionError(f"interval {k + 1} never {what} while output {k} "
                                     "was being written")


def _csvs(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".csv"))


def test_a_write_overlaps_the_next_interval(tmp_path, monkeypatch):
    model = _flagship_run(tmp_path, "overlap")
    intervals = _Intervals(monkeypatch)
    real = sio.write_output

    def write_output(grid, model, t, phys):
        k = _index(t)
        if k < N_INT:  # every output but the last has a next interval
            intervals.wait("started", k)
        return real(grid, model, t, phys)

    monkeypatch.setattr(sio, "write_output", write_output)
    tmodel.integrate_model(model, F64, device="cpu")
    assert intervals.ended == N_INT
    assert len(_csvs(model.output_dir)) == N_INT + 1


def test_the_files_are_a_synchronous_loops(tmp_path, monkeypatch):
    model = _flagship_run(tmp_path, "behind", write_spectral=True)
    order = []
    real_out, real_spec = sio.write_output, sio.write_spectral

    def write_output(grid, model, t, phys):
        order.append(("physical", t))
        return real_out(grid, model, t, phys)

    def write_spectral(grid, model, t, spec):
        order.append(("spectral", t))
        return real_spec(grid, model, t, spec)

    with monkeypatch.context() as m:
        m.setattr(sio, "write_output", write_output)
        m.setattr(sio, "write_spectral", write_spectral)
        tmodel.integrate_model(model, F64, device="cpu")

    # the synchronous loop: each boundary's files written before the next interval
    sync = _flagship_run(tmp_path, "sync", write_spectral=True)
    grid, ctx, state = tmodel.initialize(sync, F64, "cpu")
    step = tmodel.build_step(sync, grid, ctx, F64)
    expected = []
    for k in range(N_INT + 1):
        if k:
            state = tmodel.make_scan(step, STEPS)(state)
        t = k * STEPS * sync.ts
        sio.write_output(grid, sync, t, grid.synthesis(state.spec)["val"].numpy())
        sio.write_spectral(grid, sync, t, state.spec)
        expected += [("physical", t), ("spectral", t)]

    assert order == expected
    names = _csvs(model.output_dir)
    assert names == _csvs(sync.output_dir) and len(names) == 2 * (N_INT + 1)
    for name in names:
        with open(os.path.join(model.output_dir, name), "rb") as a, \
                open(os.path.join(sync.output_dir, name), "rb") as b:
            assert a.read() == b.read(), name


def test_the_spectral_file_is_its_boundarys_state(tmp_path, monkeypatch):
    """Each interval overwrites, once it has run, the state it was given, as
    the graph's replays overwrite the state's buffers on the card; each
    spectral write waits until that has happened."""
    model = _flagship_run(tmp_path, "race", write_spectral=True)
    at_boundary = []

    def overwrite(state, out):
        if not at_boundary:
            at_boundary.append(state.spec.clone())
        at_boundary.append(out.spec.clone())
        state.spec.fill_(float("nan"))
        return out

    intervals = _Intervals(monkeypatch, overwrite)
    real = sio.write_spectral

    def write_spectral(grid, model, t, spec):
        k = _index(t)
        if k < N_INT:
            intervals.wait("ended", k)
        return real(grid, model, t, spec)

    monkeypatch.setattr(sio, "write_spectral", write_spectral)
    grid, _ = tmodel.integrate_model(model, F64, device="cpu")
    assert len(at_boundary) == N_INT + 1
    for k, spec in enumerate(at_boundary):
        names, data = sio._read_csv(os.path.join(
            model.output_dir, f"spectral_out_{k * OUT_S}.csv"))
        assert names == ["coeff", *model.grid_params.vars]
        np.testing.assert_array_equal(data[:, 1:], spec.numpy().reshape(grid.nvars, -1).T)


class _DiskFull(OSError):
    pass


@pytest.mark.parametrize("failing", [0, N_INT])
def test_a_write_error_leaves_run_loop_with_its_type(failing, tmp_path, monkeypatch):
    model = _flagship_run(tmp_path, f"error{failing}")
    real = sio.write_output

    def write_output(grid, model, t, phys):
        if _index(t) == failing:
            raise _DiskFull(f"no room for output {failing}")
        return real(grid, model, t, phys)

    monkeypatch.setattr(sio, "write_output", write_output)
    with pytest.raises(_DiskFull, match=f"output {failing}"):
        tmodel.integrate_model(model, F64, device="cpu")


def test_the_watchdog_raises_at_its_boundary_after_the_writes_before_it(tmp_path,
                                                                         monkeypatch):
    bad = 2  # the fields turn non-finite in the second interval

    def poison(state, out):
        if intervals.ended + 1 == bad:
            out = out._replace(spec=torch.full_like(out.spec, float("nan")))
        return out

    intervals = _Intervals(monkeypatch, poison)
    real = sio.write_output

    def slow_write(grid, model, t, phys):
        time.sleep(0.3)  # the write before the bad boundary is still running there
        return real(grid, model, t, phys)

    monkeypatch.setattr(sio, "write_output", slow_write)
    model = _flagship_run(tmp_path, "nan")
    with pytest.raises(FloatingPointError, match="Non-finite"):
        tmodel.integrate_model(model, F64, device="cpu")
    assert intervals.started == bad
    written = _csvs(model.output_dir)
    assert written == [f"physical_out_{k * OUT_S}.csv" for k in range(bad)]
    grid = tmodel.create_grid(model.grid_params, F64, device="cpu")
    for name in written:
        names, data = sio._read_csv(os.path.join(model.output_dir, name))
        assert data.shape == (grid.num_points, len(names)) and np.isfinite(data).all()


def test_the_watchdog_error_survives_a_failing_pending_write(tmp_path, monkeypatch):
    bad = 2  # the fields turn non-finite in the second interval

    def poison(state, out):
        if intervals.ended + 1 == bad:
            out = out._replace(spec=torch.full_like(out.spec, float("nan")))
        return out

    intervals = _Intervals(monkeypatch, poison)

    def write_output(grid, model, t, phys):
        if _index(t) == bad - 1:  # the write still pending at the bad boundary
            intervals.wait("ended", bad - 1)
            raise _DiskFull(f"no room for output {bad - 1}")
        return real(grid, model, t, phys)

    real = sio.write_output
    monkeypatch.setattr(sio, "write_output", write_output)
    model = _flagship_run(tmp_path, "nan_and_full")
    with pytest.raises(FloatingPointError, match="Non-finite") as err:
        tmodel.integrate_model(model, F64, device="cpu")
    assert any(f"no room for output {bad - 1}" in n for n in err.value.__notes__)
    assert _csvs(model.output_dir) == [f"physical_out_{k * OUT_S}.csv" for k in range(bad - 1)]
