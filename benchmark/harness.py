"""One run of one cell: set-up, warm-up, the measured window, the traced
segment, and the comparison with the plain reference that decides
``correct``.

Everything that belongs to a cell is found by name: ``workloads/<cell>.json``
(configuration, traffic, warm-up and traced steps, the limits of the
comparison), ``configs/<config>.json`` (the configuration as run, and under
``small`` the grid sizes and output interval the benchmark's own tests run
it at) with the input maker ``configs/<inputs>.py``,
``traffic/<traffic>.json`` (the precision and the driver), the driver
``drivers/<driver>.py`` (what set-up, warm-up and the window run, and what
is compared), and one reader a per-layer metric in
``metrics/<metric>.py``.  The reference finds its grid,
equation set and options by name too (``benchmark/reference/``).

A driver module has ``Run(cell, seed, run_dir, device)``, which makes the
inputs from the seed, with ``setup()``, ``plan(seconds)``, ``attempted``,
``window(trace) -> (wall_s, units done, steps done, error or None)``,
``end_to_end(wall_s, steps) -> {metric: value}`` (the cell's end-to-end
metrics but ``setup_s``), ``notes()``; for the traced run ``output_gaps()``, ``replay(n)``,
``captured_graph()`` and ``shape()``; and ``release()`` and
``judge(device, control=None) -> {"program": {gaps: {variable: gap}}}``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import os
import shutil
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from benchmark import yardsticks as ys
from benchmark.reference import grid as rgrid
from benchmark.reference import stepper as rstep

BENCH = Path(__file__).resolve().parent
DTYPES = {"float32": torch.float32, "float64": torch.float64}


# ---------------------------------------------------------------------------
# the cell's files


def load_cell(name: str, bench_dir: Path = BENCH) -> dict:
    """The cell ``name``: its file, with its configuration and traffic."""
    cell = json.loads((bench_dir / "workloads" / f"{name}.json").read_text())
    cell["name"] = name
    cell["cfg"] = json.loads((bench_dir / "configs" / f"{cell['config']}.json").read_text())
    cell["traffic_params"] = json.loads(
        (bench_dir / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell


def metric_reader(name: str):
    return importlib.import_module(f"benchmark.metrics.{name}").read


def model_parameters(pkg, cfg, *, out_dir, ic_path, ref_state_file, n_steps, out_steps):
    """``pkg``'s ModelParameters (the port's or the reference's ``config``
    module) for ``cfg["model"]``, BC families by name."""
    m = cfg["model"]
    g = dict(m["grid"])
    for side, family in (("BCL", pkg.BC), ("BCR", pkg.BC), ("BCB", pkg.ZBC), ("BCT", pkg.ZBC)):
        if side in g:
            g[side] = {v: family[b] for v, b in g[side].items()}
    return pkg.ModelParameters(
        ts=m["ts"], integration_time=n_steps * m["ts"], output_interval=out_steps * m["ts"],
        equation_set=m["equation_set"], initial_conditions=ic_path, output_dir=out_dir,
        ref_state_file=ref_state_file, grid_params=pkg.GridParameters(**g),
        physical_params=dict(m["physical_params"]), options=json.loads(json.dumps(m["options"])),
    )


def output_steps(cfg) -> int:
    m = cfg["model"]
    return int(round(m["output_interval"] / m["ts"]))


# the coordinate columns of the program's CSV schema, by geometry
COORD_NAMES = {
    "R": ("r",),
    "RL": ("r", "l"),
    "RZ": ("r", "z"),
    "RLZ": ("r", "l", "z"),
    "XYZ": ("x", "y", "z"),
    "SL": ("lat", "lon"),
    "SLZ": ("lat", "lon", "z"),
}


def write_ics(path, grid, phys0):
    """The IC file in the program's CSV schema: coordinates named as the
    program names them for the geometry, then one column a variable, 17
    significant digits (a float64 reads back exactly)."""
    if grid.geometry not in COORD_NAMES:
        raise ValueError(f"no CSV coordinate columns for geometry {grid.geometry!r}")
    coords = list(COORD_NAMES[grid.geometry])
    points = grid.gridpoints()
    if points.shape[1] != len(coords):
        raise ValueError(f"{grid.geometry} grid points have {points.shape[1]} coordinates, "
                         f"the schema names {coords}")
    cols = np.concatenate([points] + [p.reshape(-1, 1) for p in phys0], axis=1)
    np.savetxt(path, cols, delimiter=",", fmt="%.17g", comments="",
               header=",".join(coords + list(grid.params.vars)))


def read_fields(path, grid) -> np.ndarray:
    """[nvars, *spatial] float64 from an output CSV, by column name."""
    with open(path) as f:
        names = f.readline().strip().split(",")
    data = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    return np.stack([data[:, names.index(v)].reshape(grid.spatial_shape)
                     for v in grid.params.vars])


# ---------------------------------------------------------------------------
# the traced segment


@dataclass
class TraceRecord:
    """What the per-layer readers read."""

    dtype_name: str
    shape: dict
    output_gaps_s: list = field(default_factory=list)
    graph_info: dict | None = None
    steps_traced: int = 0
    busy_s: float | None = None
    window_s: float | None = None
    rows: list = field(default_factory=list)  # (name, launches, device seconds, class)
    window_peak_bytes: int = 0
    window_steps: int = 0  # the measured window's steps and wall
    window_wall_s: float | None = None
    step_device_s: float | None = None  # a step's device time, replays back to back

    def class_us_per_step(self, cls):
        if not self.rows or not self.steps_traced:
            return None
        return 1e6 * sum(r[2] for r in self.rows if r[3] == cls) / self.steps_traced

    def kernel_mean_s(self, word):
        hit = [r for r in self.rows if word in r[0]]
        n = sum(r[1] for r in hit)
        return sum(r[2] for r in hit) / n if n else None


def _union_s(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def trace_segment(run, n_steps, rec: TraceRecord):
    """``run()`` (``n_steps`` graph-replayed steps) under torch.profiler,
    after one pass of it in the profiler's warm-up cycle:
    the device ops by name and class, the busy union, the wall, and the
    breakdown (the ten device ops that took longest, the ten longest idle
    gaps named by the host op that spans them)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        run()  # the profiler's warm-up cycle: its buffers, recorded nothing
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        rec.window_s = time.perf_counter() - t0
        prof.step()
    rec.steps_traced = n_steps
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("ProfilerStep"):  # the schedule's own range
            continue
        span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        (host if e.device_type() == torch.autograd.DeviceType.CPU else dev).append(span)
    by_name = {}
    for s, e, name in dev:
        n, t = by_name.get(name, (0, 0))
        by_name[name] = (n + 1, t + (e - s))
    rec.rows = sorted(((name, n, t * 1e-9, ys.kernel_class(name))
                       for name, (n, t) in by_name.items()), key=lambda r: -r[2])
    rec.busy_s = _union_s([(s, e) for s, e, _ in dev]) * 1e-9
    dev.sort()
    gaps, end = [], None
    for s, e, _ in dev:
        if end is not None and s > end:
            gaps.append((s - end, end, s))
        end = e if end is None else max(end, e)
    gaps.sort(reverse=True)
    idle = []
    for length, a, b in gaps[:10]:
        mid = 0.5 * (a + b)
        over = [h for h in host if h[0] <= mid <= h[1]]
        what = min(over, key=lambda h: h[1] - h[0])[2] if over else "no host op"
        idle.append([what[:100], length * 1e-9])
    return {"device_ops": [[r[0][:100], r[2]] for r in rec.rows[:10]], "idle_gaps": idle}


# ---------------------------------------------------------------------------
# the comparison


def field_gaps(got: np.ndarray, ref: np.ndarray, names) -> dict:
    """{variable: max |got - ref| / max |ref|} over the variable's field."""
    out = {}
    for v, name in enumerate(names):
        scale = float(np.abs(ref[v]).max())
        out[name] = float(np.abs(got[v] - ref[v]).max()) / scale if scale > 0 else float(
            np.abs(got[v]).max())
    return out


def compared(gaps: dict, rule: dict) -> float:
    """The number a check compares: the worst variable's gap, over the
    variables the cell's rule keeps (all unless it lists ``vars``)."""
    keep = rule.get("vars") or list(gaps)
    return max(gaps[v] for v in keep)


def checks_of(cell, sides_gaps: dict) -> dict:
    """{check: (value, limit, per-variable gaps)} of the cell's checks; a
    check reads the gaps named by its ``gaps`` (its own name by default)."""
    out = {}
    for name, rule in cell["checks"].items():
        gaps = sides_gaps[rule.get("gaps", name)]
        out[name] = (compared(gaps, rule), rule["limit"], gaps)
    return out


def decide(result: dict, checks: dict) -> bool:
    """``correct``: every interval completed, every check made and within
    its limit."""
    return bool(checks) and result["failed"] == 0 and all(
        v <= lim for v, lim, _ in checks.values())


class Reference:
    """The plain reference on ``device``: its own grid, context and step,
    built from the configuration and the inputs alone; float64, or for the
    control a lower precision (``tf32``: float32 with the GEMMs on TF32)."""

    def __init__(self, model, phys0, dtype, device, tf32=False):
        self.tf32 = tf32
        with self.precision():
            self.grid = rgrid.create_grid(model.grid_params, dtype, device)
            self.ctx = rstep.build_context(model, self.grid, dtype)
            self.step = rstep.build_step(model, self.grid, self.ctx, dtype)
            self.state0 = rstep.initialize(model, self.grid, self.ctx, phys0, dtype)
        self.dtype = dtype

    @contextlib.contextmanager
    def precision(self):
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    def fields(self, state) -> np.ndarray:
        with self.precision():
            return self.grid.synthesis(state.spec)["val"].double().cpu().numpy()

    def run(self, state, n):
        with self.precision():
            return rstep.run(self.step, state, n)

    def from_program(self, pstate):
        """A state of the program as the reference's (its dtype, device)."""
        return rstep.ModelState(*(t.to(self.grid.device, self.dtype) for t in pstate[:5]),
                                int(pstate.t))


# ---------------------------------------------------------------------------
# one run


@dataclass
class Outcome:
    result: dict
    checks: dict
    notes: list


def load_driver(cell):
    """The driver module the cell's traffic names:
    ``benchmark/drivers/<driver>.py``."""
    return importlib.import_module(f"benchmark.drivers.{cell['traffic_params']['driver']}")


def program_run(cell, seed, run_dir, device):
    """The cell's driver's ``Run``, its inputs made from ``seed``."""
    return load_driver(cell).Run(cell, seed, run_dir, device)


def device_seconds(run) -> float:
    """Device time of ``run()`` by CUDA events on the current stream."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3


def run_cell(cell_name, seed, seconds, trace, *, device="cuda", t_start=None,
             bench_dir: Path = BENCH):
    """One run of the cell on ``device``: an ``Outcome`` with the window's
    counts and times, the traced record (``trace``), and the checks
    {name: (value, limit, per-variable gaps)} against the reference."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(cell_name, bench_dir)
    on_card = device != "cpu"
    tmp = Path(os.environ.get("TMPDIR", "/tmp"))
    run_dir = tmp / f"scythe_bench_{cell_name}_{seed}_{os.getpid()}"
    notes = []
    try:
        pr = program_run(cell, seed, run_dir, device)
        if on_card:  # the peak is the program's: making the inputs is not
            gc.collect()
            # cuBLAS keeps a workspace for each stream it ran on: the
            # inputs' reference made three (96 MiB), the program makes its own
            clear_workspaces = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
            if clear_workspaces is not None:
                clear_workspaces()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device) if on_card else 0
        pr.setup()
        pr.plan(seconds)
        setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t_start
        wall, done, steps, error = pr.window(trace)
        window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        notes.append(f"setup {setup_s:.3f} s, window {wall:.3f} s; {held} bytes allocated "
                     f"before the program's set-up")
        notes += pr.notes()
        if error is not None:
            notes.append(f"watchdog: {error}")
        rec = breakdown = None
        if trace and error is None:
            rec = TraceRecord(pr.dtype_name, pr.shape(), output_gaps_s=pr.output_gaps(),
                              window_peak_bytes=window_peak, window_steps=steps,
                              window_wall_s=wall)
            if on_card:
                graph = pr.captured_graph()
                rec.graph_info = ys.graph_nodes(graph) if graph is not None else None
                n_tr = int(cell["trace_steps"])
                run = pr.replay(n_tr)
                breakdown = trace_segment(run, n_tr, rec)
                rec.step_device_s = device_seconds(run) / n_tr
                notes.append("kernel classes " + json.dumps(
                    {r[0][:100]: r[3] for r in rec.rows}, sort_keys=True))
                notes.append("device us a step by class " + json.dumps(
                    {c: rec.class_us_per_step(c)
                     for c in ("pointwise", "gemm", "handwritten", "lu")})
                    + f"; back to back {rec.step_device_s * 1e6:.2f} us a step")
        checks = {}
        if error is None:
            pr.release()
            t_ref = time.perf_counter()
            gaps = pr.judge(device)["program"]
            notes.append(f"the reference took {time.perf_counter() - t_ref:.3f} s")
            checks = checks_of(cell, gaps)
        return Outcome(
            result={"attempted": pr.attempted, "failed": pr.attempted - done, "steps": steps,
                    "wall_s": wall, "end_to_end": pr.end_to_end(wall, steps), "setup_s": setup_s, "window_peak_bytes": window_peak,
                    "peak_bytes": max(setup_peak, window_peak), "record": rec,
                    "breakdown": breakdown},
            checks=checks, notes=notes)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
