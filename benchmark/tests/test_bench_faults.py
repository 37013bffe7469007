"""A run with its timed path broken underneath comes out not correct.

Each test drives the whole of a run but the look for a card, on the CPU at
a small size (``small_bench``) with the cells' own limits, once sound and
once with each fault these cells can have: a step that returns its state
unchanged, and an answer altered where it is written.  (The cells run one
member on one card: no batch can lose half its rows and no exchange
between cards can be left out.)  The cells are ``BENCHMARK.json``'s."""

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import CELLS


def run(cell, bench):
    torch.set_num_threads(2)
    out = harness.run_cell(cell, 2**31 + 11, 0.1, False, device="cpu", bench_dir=bench)
    return harness.decide(out.result, out.checks), out


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, small_bench):
    from scythe_tpu_torch.ops import _build

    correct, out = run(cell, small_bench)
    assert correct, out.checks
    # the notes name the CSV writer the program used
    writer = "csv_writer.cpp" if _build.load_host() is not None else "numpy"
    assert any(n.startswith(f"writer {writer};") for n in out.notes), out.notes


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_returns_its_state_unchanged(cell, small_bench, monkeypatch):
    from scythe_tpu_torch import model as tmodel

    build = tmodel.build_step

    def broken(*a, **k):
        build(*a, **k)
        return lambda state: state._replace(t=state.t + 1)

    monkeypatch.setattr(tmodel, "build_step", broken)
    correct, out = run(cell, small_bench)
    assert not correct, out.checks


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_written(cell, small_bench, monkeypatch):
    from scythe_tpu_torch import io as sio

    write = sio.write_output

    def altered(grid, model, t, phys):
        phys = phys.copy()
        phys[0] = 1.5 * phys[0]
        return write(grid, model, t, phys)

    monkeypatch.setattr(sio, "write_output", altered)
    correct, out = run(cell, small_bench)
    assert not correct, out.checks
