"""The readers of the program's own spans and counters
(``scythe_tpu_torch.trace``), and on the card what those spans and counters
say.

On the CPU: after a traced run of each cell at a small size, its steady step
captured by a stand-in for the CUDA graph that counts the ops its capture
runs as nodes, every reader but ``boundary_idle_ms`` (the card's clock)
returns a number; on an empty registry, and on a program without one, each
returns None.

On the card (``-m chip``): the stage node counts of each cell's captured
step add up to the graph's nodes by ``cuGraphGetNodes``, and with the stage
events off the graph is the one the benchmark's ``graph_nodes`` reads;
with them on, the stages' device times of a TC replay add up to within 5%
of a step's device time by CUDA events around the replays; in a profiler
trace of ``run_loop`` each boundary's fetch starts after every kernel of
its interval has ended; and ``integrate_model(profile_dir=)`` leaves the
ranges in ``trace.json`` and closes its log with the stages' device times.
"""

import functools
import json
import os
import sys

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark import harness
from benchmark import yardsticks as ys

READERS = ("fetch_ms", "watchdog_ms", "write_ms", "boundary_idle_ms", "capture_ms",
           "tendency_nodes")
CELLS = ["tc_mature.f32", "cha_bell.f32"]


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


class CountingCapture:
    """A capture primitive on the CPU: the capture runs the step once on the
    buffers, counting its ops as the graph's nodes, and gives the buffers
    back; a replay calls the step again."""

    def warm(self, fn, device):
        fn()

    def capture(self, fn, device, buffers):
        saved = [b.clone() for b in buffers]
        self.ops = _Ops()
        with self.ops:
            fn()
        for b, s in zip(buffers, saved):
            b.copy_(s)
        self.total = self.ops.n
        return fn

    def nodes_now(self):
        return self.ops.n

    def graph_nodes(self, replay):
        return self.total


def _rec():
    return harness.TraceRecord("float32", {})


@pytest.mark.parametrize("cell", CELLS)
def test_the_readers_read_a_traced_run(cell, small_bench, monkeypatch):
    from scythe_tpu_torch import graphs

    torch.set_num_threads(2)
    monkeypatch.setattr(graphs, "scan", functools.partial(graphs.scan,
                                                          capture=CountingCapture()))
    out = harness.run_cell(cell, 2**31 + 5, 0.1, True, device="cpu", bench_dir=small_bench)
    assert harness.decide(out.result, out.checks), out.checks
    got = {name: harness.metric_reader(name)(out.result["record"]) for name in READERS}
    assert got.pop("boundary_idle_ms") is None  # no card, no card clock
    assert all(isinstance(v, float) and v > 0 for v in got.values()), got
    # the spans cover the boundaries output_ms reads: the window's initial
    # output and one after each interval
    from scythe_tpu_torch import trace

    for name in ("fetch", "watchdog", "write"):
        assert (trace.last_run().spans[f"run_loop.{name}"].count
                == len(out.result["record"].output_gaps_s) == out.result["attempted"] + 1)


def test_the_readers_read_nothing_from_an_empty_registry(monkeypatch):
    from scythe_tpu_torch import trace

    monkeypatch.setattr(trace, "_process", trace.Record())
    monkeypatch.setattr(trace, "_last", None)
    for name in READERS:
        assert harness.metric_reader(name)(_rec()) is None, name
    monkeypatch.setitem(sys.modules, "scythe_tpu_torch.trace", None)  # a program without it
    for name in READERS:
        assert harness.metric_reader(name)(_rec()) is None, name


# ------------------------------------------------------------- the card


@pytest.fixture(scope="module")
def tc_run(tmp_path_factory):
    """The TC cell's set-up on the card with the stages timed: its warm-up
    ``run_loop`` captures the steady step with the stage events inside."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    from scythe_tpu_torch import trace

    pr = harness.program_run(harness.load_cell("tc_mature.f32"), 2**31 + 7,
                             tmp_path_factory.mktemp("tc"), "cuda")
    with trace.stage_times():
        pr.setup()
    yield pr
    pr.release()


def _runner(step):
    from scythe_tpu_torch import graphs

    (runner,) = graphs.captured(step).values()
    return runner


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_the_stage_nodes_add_up_to_the_graph(cell, card, tmp_path):
    from scythe_tpu_torch import trace

    pr = harness.program_run(harness.load_cell(cell), 2**31 + 3, tmp_path, card)
    before = trace.process()
    pr.setup()
    runner = _runner(pr.step)
    graph = ys.graph_nodes(pr.captured_graph())
    assert runner.nodes == graph["nodes"] == sum(runner.stage_nodes.values())
    assert tuple(runner.stage_nodes) == trace.STAGES
    assert runner.stage_events == []
    after = trace.process()
    assert (after.total("graph.nodes.tendency") - (before.total("graph.nodes.tendency") or 0)
            == runner.stage_nodes["tendency"])
    print(f"{cell}: {runner.nodes} nodes, by stage {json.dumps(runner.stage_nodes)}; "
          f"{graph}")
    pr.release()


@pytest.mark.chip
def test_the_stage_times_add_up_to_a_step(tc_run, card):
    from scythe_tpu_torch import trace

    runner = _runner(tc_run.step)
    assert len(runner.stage_events) == len(trace.STAGES)
    assert runner.nodes == sum(runner.stage_nodes.values())
    rec = trace.last_run()  # the warm-up run_loop: two intervals
    stages = {name: rec.mean(f"stage_s.{name}") for name in trace.STAGES}
    assert all(v is not None and v >= 0 for v in stages.values()), stages
    n = 200
    step_s = harness.device_seconds(tc_run.replay(n)) / n
    staged = sum(stages.values())
    print(f"stage device us a step {json.dumps({k: 1e6 * v for k, v in stages.items()})}; "
          f"sum {1e6 * staged:.2f}, a step back to back {1e6 * step_s:.2f}")
    assert abs(staged - step_s) <= 0.05 * step_s


@pytest.mark.chip
def test_the_fetch_starts_after_its_interval_on_the_card(tc_run, card):
    from torch.profiler import ProfilerActivity, profile

    w = tc_run.warm_steps
    model = tc_run.model(tc_run.tconfig, "profiled", 3 * w, w)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tc_run.tmodel.run_loop(model, tc_run.grid, tc_run.ctx, tc_run.spans.last,
                               tc_run.step, tc_run.dtype)
    host, dev = [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if e.name() == "run_loop.fetch":
                host.append(span)
        else:
            dev.append(span)
    assert len(host) == 4 and dev
    for start, _ in sorted(host)[1:]:
        ended = max(e for s, e in dev if s < start)
        assert ended <= start, (start, ended)


@pytest.mark.chip
def test_profile_dir_leaves_the_ranges_and_the_stage_times(tc_run, card, tmp_path):
    w = tc_run.warm_steps
    model = tc_run.model(tc_run.tconfig, "profile_dir", 2 * w, w)
    tc_run.tmodel.integrate_model(model, tc_run.dtype, profile_dir=str(tmp_path / "prof"))
    names = {e.get("name") for e in json.loads(
        (tmp_path / "prof" / "trace.json").read_text())["traceEvents"]}
    assert {"run_loop", "run_loop.fetch", "run_loop.watchdog", "run_loop.write",
            "run_loop.interval", "run_loop.drain", "graph.capture", "synthesis", "tendency",
            "copies"} <= names
    with open(os.path.join(model.output_dir, "scythe_out.log")) as f:
        last = f.read().splitlines()[-1]
    assert last.startswith("Stage device us a step") and "tendency" in last, last
    print(last)
