"""The reader of the run loop's wait for its background writer
(``write_wait_ms``, the program's span ``run_loop.write_wait``).

On the CPU, after a traced run of each cell at a small size: a number of
milliseconds, not negative, from one wait a boundary (the window's initial
output and one after each interval); on an empty registry, and on a
program without one, None.
"""

import functools
import sys

import pytest
import torch

from benchmark import harness
from benchmark.tests.test_bench_trace import CELLS, CountingCapture, _rec


@pytest.mark.parametrize("cell", CELLS)
def test_write_wait_reads_a_traced_run(cell, small_bench, monkeypatch):
    from scythe_tpu_torch import graphs, trace

    torch.set_num_threads(2)
    monkeypatch.setattr(graphs, "scan", functools.partial(graphs.scan,
                                                          capture=CountingCapture()))
    out = harness.run_cell(cell, 2**31 + 7, 0.1, True, device="cpu", bench_dir=small_bench)
    assert harness.decide(out.result, out.checks), out.checks
    got = harness.metric_reader("write_wait_ms")(out.result["record"])
    assert isinstance(got, float) and got >= 0.0, got
    rec = trace.last_run()
    assert rec.spans["run_loop.write_wait"].count == out.result["attempted"] + 1


def test_write_wait_reads_nothing_without_the_span(monkeypatch):
    from scythe_tpu_torch import trace

    reader = harness.metric_reader("write_wait_ms")
    monkeypatch.setattr(trace, "_last", None)
    assert reader(_rec()) is None
    monkeypatch.setitem(sys.modules, "scythe_tpu_torch.trace", None)  # a program without it
    assert reader(_rec()) is None
