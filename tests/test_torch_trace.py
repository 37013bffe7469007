"""The port's registry of spans and counters (scythe_tpu_torch/trace.py) on
the CPU.

* ``run_loop``: a run of N outputs gives its run record N + 1 fetch,
  watchdog, write_wait and write spans, N interval and drain spans, and
  ``output_bytes`` the files' sizes; a second call replaces the first in ``last_run()``;
  checkpoints have their span; the closing log line reads the record.
* Spans added from shard threads at once add up without loss.
* Under ``torch.profiler`` (every thread's ranges) the spans are ranges
  nested in ``run_loop``'s, the writer thread's writes among them, and a
  span's registry start lies within 1 ms of its profiler event's.
* Through ``StubGraph`` (tests/test_torch_graph_scan.py), counting the ops
  its capture runs as its nodes: the stage node counts cover the ten stages
  in order and add up to the captured graph's nodes, on the flagship, the
  moist semi-implicit core and the TC option bundle.
* Stages nest: a stage entered inside another counts its nodes (and its
  timing events) under its own name and the outer stage's count leaves them
  out, so the counts still add up; an SLZ step with ``hyperdiffusion_k4``
  counts its del^4 refit as the ``hyperdiffusion`` stage (and without it has
  no such stage), and an RLZ step's counts are those of stages that do not
  nest.
* The launch counters are added once a chunk, and read what they read when
  they were added once a replay; a count another thread makes during a
  capture lands once, and is not multiplied by the replays.
* ``ops._build``'s nvcc time is the span ``ops.build``.
"""

import functools
import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import scythe_tpu_torch as tx
from scythe_tpu_torch import graphs
from scythe_tpu_torch import io as sio
from scythe_tpu_torch import model as tmodel
from scythe_tpu_torch import trace
from scythe_tpu_torch.examples import cha_bell_initialization as cb
from scythe_tpu_torch.ops import _build

from test_torch_graph_scan import StubGraph, _moist, _tc, stub_scan

torch.set_num_threads(2)
F64 = torch.float64


def _flagship_run(tmp_path, name, t_end=36.0, out=9.0, **options):
    """The flagship at 8 cells x 16, ts 3 s, an output every ``out`` s."""
    model = cb.flagship_model(8, 16)
    ics = tmp_path / "ics.csv"
    if not ics.exists():
        grid = tx.create_grid(model.grid_params, F64, device="cpu")
        cols = np.concatenate([grid.gridpoints(), cb.vortex_phys(grid).reshape(6, -1).T],
                              axis=1)
        sio._write_csv(str(ics), ["r", "l", *model.grid_params.vars], cols)
    return model.with_(integration_time=t_end, output_interval=out, initial_conditions=str(ics),
                       output_dir=str(tmp_path / name),
                       options={**model.opts(), **options})


def _counts(rec):
    return {k: s.count for k, s in rec.spans.items()}


def test_run_loop_spans_each_boundary(tmp_path):
    model = _flagship_run(tmp_path, "four", write_spectral=True)
    tmodel.integrate_model(model, F64, device="cpu")
    rec = trace.last_run()
    n = 4
    got = _counts(rec)
    assert got["run_loop"] == 1
    for name in ("fetch", "watchdog", "write_wait", "write"):
        assert got[f"run_loop.{name}"] == n + 1, name
    for name in ("interval", "drain"):
        assert got[f"run_loop.{name}"] == n, name
    assert "run_loop.checkpoint" not in got
    written = [f for f in os.listdir(model.output_dir) if f.endswith(".csv")]
    assert len(written) == 2 * (n + 1)  # physical and spectral at every output
    assert rec.counters["output_bytes"].count == 2 * (n + 1)
    assert rec.total("output_bytes") == sum(
        os.path.getsize(os.path.join(model.output_dir, f)) for f in written)
    write = rec.spans["run_loop.write"]
    assert write.total / write.count <= write.max <= write.total
    # no card: no event, so no idle on the card's clock and no stage times
    assert "boundary_idle_s" not in rec.counters
    assert not any(k.startswith("stage_s.") for k in rec.counters)
    with open(os.path.join(model.output_dir, "scythe_out.log")) as f:
        done = [ln for ln in f if ln.startswith("Done:")]
    assert len(done) == 1
    assert "steps/s" in done[0] and "fetch" in done[0] and "write_wait" in done[0], done
    # the writer's thread runs beside this one: this thread's parts, its
    # wait for the writer among them, lie within the call
    parts = sum(rec.total(f"run_loop.{p}") for p in
                ("fetch", "watchdog", "write_wait", "interval", "drain"))
    assert parts <= rec.total("run_loop")


def test_a_second_call_replaces_the_first(tmp_path):
    tmodel.integrate_model(_flagship_run(tmp_path, "four"), F64, device="cpu")
    first = trace.last_run()
    tmodel.integrate_model(_flagship_run(tmp_path, "two", t_end=18.0), F64,
                           write_outputs=False, device="cpu")
    second = trace.last_run()
    assert second is not first
    got = _counts(second)
    assert got["run_loop.interval"] == 2 and got["run_loop.fetch"] == 3
    assert "run_loop.write" not in got and "output_bytes" not in second.counters
    assert got["run_loop.watchdog"] == 2  # the initial output is not checked unwritten
    assert _counts(first)["run_loop.interval"] == 4


def test_a_checkpoint_has_its_span(tmp_path):
    tmodel.integrate_model(_flagship_run(tmp_path, "ckpt", checkpoint_interval=18.0), F64,
                           device="cpu")
    assert _counts(trace.last_run())["run_loop.checkpoint"] == 2


def test_spans_from_shard_threads_add_up():
    n_threads, n = 4, 500
    before = trace.process().stat("shard.step")
    before = before.count if before else 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.run() as rec:
            def work():
                for _ in range(n):
                    with trace.span("shard.step"):
                        pass
                    trace.count("shard.items", 2)

            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert rec.spans["shard.step"].count == n_threads * n
    assert rec.counters["shard.items"].count == n_threads * n
    assert rec.total("shard.items") == 2 * n_threads * n
    assert trace.process().stat("shard.step").count == before + n_threads * n


def test_spans_nest_in_run_loop_under_the_profiler(tmp_path):
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    # every thread's ranges: the writes run on the run loop's writer thread
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        tmodel.integrate_model(_flagship_run(tmp_path, "prof"), F64, device="cpu")
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    (outer,) = [e for e in events if e[0] == "run_loop"]
    inner = [e for e in events if e[0].startswith("run_loop.")]
    assert {e[0] for e in inner} == {f"run_loop.{p}" for p in
                                     ("fetch", "watchdog", "write_wait", "write", "interval",
                                      "drain")}
    assert all(outer[1] <= s and e <= outer[2] for _, s, e in inner)
    # the stages of every (eager) step are ranges too
    assert {"synthesis", "tendency", "update", "analysis"} <= {e[0] for e in events}
    rec = trace.last_run()
    for name in ("run_loop", "run_loop.fetch", "run_loop.write"):
        last = max(s for n, s, _ in events if n == name)
        assert abs(rec.spans[name].start_ns - last) < 1e6, name


class CountingStub(StubGraph):
    """``StubGraph`` whose graph's nodes are the ops its capture runs."""

    class _Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    def capture(self, fn, device, buffers):
        self.ops = self._Ops()

        def counted():
            with self.ops:
                fn()

        replay = super().capture(counted, device, buffers)
        self.total = self.ops.n
        return replay

    def nodes_now(self):
        return self.ops.n

    def graph_nodes(self, replay):
        return self.total


def _flagship_state():
    model = cb.flagship_model(8, 16)
    grid = tx.create_grid(model.grid_params, F64, device="cpu")
    ctx = tmodel.build_context(model, grid, F64)
    return (None, None, None, None), (model, grid, ctx, cb.vortex_state(grid, F64))


@pytest.mark.parametrize("name", ["flagship", "moist_rlz_si", "tc_bundle_implicit_vdiff"])
def test_stage_nodes_cover_the_stages_and_add_up(name, tmp_path):
    make = {"flagship": _flagship_state, "moist_rlz_si": lambda: _moist(tmp_path, 6),
            "tc_bundle_implicit_vdiff": lambda: _tc(tmp_path, 6)}[name]
    _, (model, grid, ctx, state) = make()
    step = tmodel.build_step(model, grid, ctx, F64)
    before = trace.process()
    stub = CountingStub()
    stub_scan(step, 6, state, stub)
    (runner,) = graphs.captured(step).values()
    assert tuple(runner.stage_nodes) == trace.STAGES
    assert runner.nodes == stub.total > 0
    assert sum(runner.stage_nodes.values()) == runner.nodes
    assert runner.stage_nodes["tendency"] > 0 and runner.stage_nodes["copies"] > 0
    after = trace.process()

    def added(key):
        return after.total(key) - (before.total(key) or 0)

    assert added("graph.nodes") == runner.nodes
    for stage, n in runner.stage_nodes.items():
        assert added(f"graph.nodes.{stage}") == n
    assert after.stat("graph.capture").count == (
        before.stat("graph.capture").count if before.stat("graph.capture") else 0) + 1
    assert runner.stage_events == []  # stage times are off


def test_the_log_reads_the_graph_nodes_and_the_bytes(tmp_path, monkeypatch):
    monkeypatch.setattr(graphs, "scan", functools.partial(graphs.scan, capture=CountingStub()))
    model = _flagship_run(tmp_path, "log")
    tmodel.integrate_model(model, F64, device="cpu")
    rec = trace.last_run()
    with open(os.path.join(model.output_dir, "scythe_out.log")) as f:
        lines = f.read().splitlines()
    assert lines[-2].startswith("Done:")
    assert lines[-2].endswith(f"; {rec.total('output_bytes'):.0f} bytes written")
    assert lines[-1] == (f"Graph: {rec.total('graph.nodes'):.0f} nodes a step; by stage: "
                         + ", ".join(f"{s} {rec.total(f'graph.nodes.{s}'):.0f}"
                                     for s in trace.STAGES))


def test_a_primitive_that_counts_no_nodes_counts_none(tmp_path):
    _, (model, grid, ctx, state) = _flagship_state()
    step = tmodel.build_step(model, grid, ctx, F64)
    stub_scan(step, 5, state)
    (runner,) = graphs.captured(step).values()
    assert runner.nodes is None and runner.stage_nodes == {}


class _Nodes:
    """A graph being captured: ``add(n)`` adds nodes."""

    def __init__(self):
        self.n = 0

    def add(self, n):
        self.n += n

    def __call__(self):
        return self.n


def test_a_nested_stage_counts_its_nodes_once():
    nodes = _Nodes()
    with trace.capturing(nodes, "cpu") as cap:
        with trace.stage("synthesis"):
            nodes.add(3)
        with trace.stage("tendency"):
            nodes.add(5)
            with trace.stage("hyperdiffusion"):
                nodes.add(7)
            nodes.add(2)
            with trace.stage("hyperdiffusion"):  # a second entry adds to the first
                nodes.add(1)
        with trace.stage("copies"):
            nodes.add(4)
    assert cap.nodes == {"synthesis": 3, "hyperdiffusion": 8, "tendency": 7, "copies": 4}
    assert sum(cap.nodes.values()) == nodes.n == 22
    assert cap.open == []


def test_a_nested_stage_splits_the_outer_stages_events(monkeypatch):
    """With the stage times on, the outer stage's events are the segments
    around the inner one, which has its own; their times sum by name."""
    marks = iter(range(100))
    monkeypatch.setattr(trace, "_event", lambda: next(marks))
    nodes = _Nodes()
    with trace.capturing(nodes, "cpu") as cap:
        cap.timed = True
        with trace.stage("tendency"):
            nodes.add(5)
            with trace.stage("hyperdiffusion"):
                nodes.add(7)
        with trace.stage("update"):
            pass
    assert cap.events == [("tendency", 0, 1), ("hyperdiffusion", 1, 2), ("tendency", 2, 3),
                          ("update", 4, 5)]
    assert cap.nodes == {"hyperdiffusion": 7, "tendency": 5, "update": 0}

    class Mark(int):
        def elapsed_time(self, other):  # ms, as a CUDA event's
            return float(other - self)

    runner = graphs.CapturedStep.__new__(graphs.CapturedStep)
    runner.stage_events = [(n, Mark(a), Mark(b)) for n, a, b in cap.events]
    runner._timed_replays = 1
    assert runner.stage_seconds() == {"tendency": 2e-3, "hyperdiffusion": 1e-3,
                                      "update": 1e-3}


def _slz_step(tmp_path, k4):
    """A small JW06 step with the production options (8 cells x 16 x 8),
    del^4 on at ``k4`` or off."""
    from scythe_tpu_torch.examples import jw06_baroclinic_slz as jw

    model = jw.build_model(str(tmp_path / f"jw06_{k4}"), num_cells=8, nl=16, zdim=8, ts=7.5,
                           l_q=0.0, sponge_top=12.0e3, k4=k4, smag=0.21)
    grid64 = tx.create_grid(model.grid_params, F64, device="cpu")
    phys0 = jw.initial_fields(grid64, tmodel.build_context(model, grid64, F64).ref_state)
    _, _, state, step = jw.prepare_run(model, phys0, F64, "cpu")
    return step, state


def test_an_slz_step_counts_its_del4_refit_as_a_stage(tmp_path):
    counts = {}
    for k4 in (6.0e16, 0.0):
        step, state = _slz_step(tmp_path, k4)
        before = trace.process()
        stub = CountingStub()
        stub_scan(step, 5, state, stub)
        (runner,) = graphs.captured(step).values()
        assert sum(runner.stage_nodes.values()) == runner.nodes == stub.total
        assert set(runner.stage_nodes) - set(trace.STAGES) <= set(trace.SUBSTAGES)
        added = trace.process().total("graph.nodes.hyperdiffusion") or 0
        added -= before.total("graph.nodes.hyperdiffusion") or 0
        assert added == runner.stage_nodes.get("hyperdiffusion", 0)
        counts[k4] = runner.stage_nodes
    on, off = counts[6.0e16], counts[0.0]
    assert on["hyperdiffusion"] > 0 and "hyperdiffusion" not in off
    # the tendency's own count leaves the refit out
    assert on["tendency"] == off["tendency"]
    assert {k: v for k, v in on.items() if k != "hyperdiffusion"} == off


class _FlatStage:
    """The stage marker as it was before stages nested: each adds every
    node its block adds."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.cap = getattr(trace._tls, "capture", None)
        if self.cap is not None:
            self.n0 = self.cap.nodes_now()
        return self

    def __exit__(self, *exc):
        if self.cap is not None:
            self.cap.nodes[self.name] = (self.cap.nodes.get(self.name, 0)
                                         + self.cap.nodes_now() - self.n0)
        return False


def test_an_rlz_steps_stage_counts_are_unchanged(tmp_path, monkeypatch):
    _, (model, grid, ctx, state) = _tc(tmp_path, 6)
    counts = []
    for marker in (trace.stage, _FlatStage):
        monkeypatch.setattr(trace, "stage", marker)
        step = tmodel.build_step(model, grid, ctx, F64)
        stub_scan(step, 5, state, CountingStub())
        (runner,) = graphs.captured(step).values()
        counts.append(runner.stage_nodes)
    assert counts[0] == counts[1]
    assert tuple(counts[0]) == trace.STAGES


def test_launch_counters_are_added_once_a_chunk():
    _, (model, grid, ctx, state) = _flagship_state()
    inner = tmodel.build_step(model, grid, ctx, F64)
    name = "column_solve.launches"

    def step(state):  # a wrapper that counts as a kernel's does
        trace.count(name, 1)
        return inner(state)

    def total_and_adds():
        stat = trace.process().stat(name)
        return (stat.total, stat.count) if stat else (0, 0)

    n0, c0 = total_and_adds()
    out = stub_scan(step, 8, state)  # 2 start-up, the warm-up, 5 replays
    # an add a start-up and warm-up step, the capture's held, then one for the replays
    assert total_and_adds() == (n0 + 8, c0 + 4)
    stub_scan(step, 4, out)
    assert total_and_adds() == (n0 + 12, c0 + 5)


class _OtherThread(StubGraph):
    """A stub capture during which another thread counts, as a shard thread
    or ``run_loop``'s writer may."""

    def capture(self, fn, device, buffers):
        t = threading.Thread(target=trace.count, args=("other.thread", 1))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        return super().capture(fn, device, buffers)


def test_another_threads_count_during_a_capture_lands_once():
    _, (model, grid, ctx, state) = _flagship_state()
    inner = tmodel.build_step(model, grid, ctx, F64)
    name = "column_solve.launches"

    def step(state):
        trace.count(name, 1)
        return inner(state)

    other0, n0 = (trace.process().total(k) or 0 for k in ("other.thread", name))
    stub_scan(step, 8, state, _OtherThread())  # 2 start-up, the warm-up, 5 replays
    (runner,) = graphs.captured(step).values()
    assert runner.counts == {name: 1}
    assert (trace.process().total("other.thread") or 0) == other0 + 1
    assert (trace.process().total(name) or 0) == n0 + 8


def test_the_build_time_is_its_span(tmp_path, monkeypatch):
    def compile_(sources, path):
        path.write_bytes(b"")
        return "built"

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_compile", compile_)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(_build, "_declare", lambda lib: None)
    n0 = trace.process().stat("ops.build")
    built = _build._load.__wrapped__()
    stat = trace.process().stat("ops.build")
    assert stat.count == (n0.count if n0 else 0) + 1
    assert built.seconds > 0 and built.log == "built"
    assert stat.total - (n0.total if n0 else 0) == built.seconds
    again = _build._load.__wrapped__()  # reused: no build, no span
    assert again.seconds == 0.0 and trace.process().stat("ops.build").count == stat.count
