"""The ``run_loop`` driver: one integration through the program's own entry,
the path ``integrate_model`` takes.

Set-up: ``scythe_tpu_torch.model.initialize`` and ``build_step``, then a
warm-up ``model.run_loop`` on the same step (two intervals of the cell's
``warmup_steps``: the capture, then a rate) and, on a card, ``SETTLE_S``
seconds of replays whose results are dropped.  The
window: one ``run_loop`` call of as many whole output intervals as fill
``seconds`` at the warm-up's rate, never past the configuration's
``integration_time``; it replays the captured graph of the steady step
between outputs and fetches, checks and writes the fields at every output.

The comparison: the warm-up's outputs against the float64 reference run
from the same inputs (``warmup_gap``), and one window interval drawn from
the seed against the reference run from the program's own state entering
it (``interval_gap``).
"""

from __future__ import annotations

import gc
import importlib
import os
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import config as rconfig
from benchmark.reference import grid as rgrid

SETTLE_S = 10.0


class Spans:
    """Wraps ``model.make_scan`` and ``io.write_output`` of the program for
    the run's duration: the host time between the end of one interval's
    steps and the next interval's start (``sync`` makes an interval end when
    its device work does), the state entering the interval ``keep``, the
    last state returned, and each output's path and size."""

    def __init__(self, tmodel, sio):
        self.tmodel, self.sio = tmodel, sio
        self._make_scan, self._write = tmodel.make_scan, sio.write_output
        self.sync = False
        self.keep = None
        self.reset()

    def reset(self):
        self.chunks = 0
        self.kept = None
        self.last = None
        self.prev_end = None
        self.gaps = []
        self.chunk_s = []
        self.outputs = []

    def __enter__(self):
        spans = self

        def make_scan(step, n_steps):
            chunk = spans._make_scan(step, n_steps)

            def timed(state):
                t0 = time.perf_counter()
                if spans.prev_end is not None:
                    spans.gaps.append(t0 - spans.prev_end)
                if spans.chunks == spans.keep:
                    spans.kept = state
                out = chunk(state)
                if spans.sync:
                    torch.cuda.synchronize()
                spans.prev_end = time.perf_counter()
                spans.chunk_s.append(spans.prev_end - t0)
                spans.chunks += 1
                spans.last = out
                return out

            return timed

        def write_output(grid, model, t, phys):
            path = spans._write(grid, model, t, phys)
            spans.outputs.append((float(t), path, os.path.getsize(path)))
            return path

        self.tmodel.make_scan, self.sio.write_output = make_scan, write_output
        return self

    def __exit__(self, *exc):
        self.tmodel.make_scan, self.sio.write_output = self._make_scan, self._write
        return False


class Run:
    """Set-up, warm-up and window of one cell on ``device``; the program's
    products (the outputs on disk, the state entering the judged interval)
    are kept for the comparison."""

    def __init__(self, cell, seed, run_dir, device):
        self.cell, self.seed, self.run_dir, self.device = cell, seed, Path(run_dir), device
        cfg = cell["cfg"]
        self.cfg = cfg
        self.dtype_name = cell["traffic_params"]["dtype"]
        self.dtype = harness.DTYPES[self.dtype_name]
        self.rng = np.random.default_rng(seed % 2**63)
        self.n_out = harness.output_steps(cfg)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        inputs = importlib.import_module(f"benchmark.configs.{cfg.get('inputs', cfg['name'])}")
        self.ic_path = str(self.run_dir / "ics.csv")

        m = harness.model_parameters(rconfig, cfg, out_dir="", ic_path="", ref_state_file="",
                                     n_steps=1, out_steps=1)
        grid = rgrid.create_grid(m.grid_params, torch.float64, "cpu")  # its points
        self.phys0, self.ref_state_file = inputs.make_inputs(
            cfg, grid, str(self.run_dir), self.rng, device)
        harness.write_ics(self.ic_path, grid, self.phys0)

    def model(self, pkg, out, n_steps, out_steps):
        return harness.model_parameters(
            pkg, self.cfg, out_dir=str(self.run_dir / out), ic_path=self.ic_path,
            ref_state_file=self.ref_state_file, n_steps=n_steps, out_steps=out_steps)

    def reference_model(self):
        return self.model(rconfig, "ref", self.n_out, self.n_out)

    def setup(self):
        import scythe_tpu_torch.config as tconfig
        from scythe_tpu_torch import io as sio
        from scythe_tpu_torch import model as tmodel

        self.tmodel, self.sio, self.tconfig = tmodel, sio, tconfig
        w = int(self.cell["warmup_steps"])
        self.warm_steps = w
        self.model_warm = self.model(tconfig, "warm", 2 * w, w)
        self.grid, self.ctx, state = tmodel.initialize(self.model_warm, self.dtype, self.device)
        self.step = tmodel.build_step(self.model_warm, self.grid, self.ctx, self.dtype)
        self.spans = Spans(tmodel, sio)
        self.spans.sync = self.device != "cpu"
        with self.spans:
            tmodel.run_loop(self.model_warm, self.grid, self.ctx, state, self.step, self.dtype)
        sp = self.spans
        self.warm_outputs = [(i * w, p) for i, (_, p, _) in enumerate(sp.outputs)]
        self.state = sp.last
        # SETTLE_S of replays from the window's starting state, their results
        # dropped: in a process's first seconds of steady load the card ran
        # the step 19-26% slower at its full reported clocks (cause not
        # found); without them both cells' runs spread about 10%
        if self.device != "cpu":
            t_end = time.perf_counter() + SETTLE_S
            while time.perf_counter() < t_end:
                tmodel.make_scan(self.step, w)(self.state)
                torch.cuda.synchronize(self.device)
        # the rate of replays (the second interval) and the host time of an
        # output, from which the window's whole number of intervals is set
        self.rate = w / sp.chunk_s[1]
        self.output_s = sum(sp.gaps) / max(len(sp.gaps), 1)

    def plan(self, seconds):
        """The window's intervals: about ``seconds`` of them at the warm-up's
        rate, but with the warm-up no more than the configuration's
        integration time (a faster program gets a shorter window there, not
        a longer simulation)."""
        per = self.n_out / self.rate + self.output_s
        m = self.cfg["model"]
        cap = (int(round(m["integration_time"] / m["ts"])) - 2 * self.warm_steps) // self.n_out
        self.n_int = max(1, min(int(round(seconds / per)), cap))
        # the judged interval, drawn from the seed
        self.judged = int(np.random.default_rng([self.seed % 2**63, 1]).integers(self.n_int))

    @property
    def attempted(self) -> int:
        return self.n_int

    def window(self, trace: bool):
        """The measured run_loop: (wall seconds, intervals completed, steps
        completed, the watchdog's FloatingPointError or None)."""
        tmodel = self.tmodel
        model = self.model(self.tconfig, "window", self.n_int * self.n_out, self.n_out)
        sp = self.spans
        sp.reset()
        sp.sync = trace and self.device != "cpu"
        sp.keep = self.judged
        if self.device != "cpu":
            torch.cuda.synchronize(self.device)
        error = None
        with sp:
            t0 = time.perf_counter()
            sp.prev_end = t0  # the first boundary: the window's initial output
            try:
                tmodel.run_loop(model, self.grid, self.ctx, self.state, self.step, self.dtype)
            except FloatingPointError as e:
                error = e
            if self.device != "cpu":
                torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
        if error is None:
            sp.gaps.append(t1 - sp.prev_end)  # the last output boundary
        done = max(len(sp.outputs) - 1, 0)
        self.outputs = [o[1] for o in sp.outputs]
        return t1 - t0, done, done * self.n_out, error

    def end_to_end(self, wall_s, steps) -> dict:
        """``steps_per_s``: the window's steps over its wall, outputs and
        watchdog included."""
        return {"steps_per_s": steps / wall_s} if wall_s > 0 else {}

    def notes(self) -> list[str]:
        sp = self.spans
        written = sum(o[2] for o in sp.outputs)
        from scythe_tpu_torch.ops import _build

        # the program's CSV writer: its host library where a host compiler
        # built it (cached by the window's writes), else numpy
        writer = "csv_writer.cpp" if _build.load_host() is not None else "numpy"
        return [f"writer {writer}; the window wrote {written} bytes in {len(sp.outputs)} "
                f"outputs; {self.n_int} intervals of {self.n_out} steps, interval "
                f"{self.judged} judged",
                "interval seconds " + " ".join(f"{c:.4f}" for c in sp.chunk_s)
                + "; output boundaries " + " ".join(f"{g:.4f}" for g in sp.gaps)]

    # -- what the traced run reads ------------------------------------------

    def output_gaps(self) -> list[float]:
        return list(self.spans.gaps)

    def replay(self, n_steps):
        """A callable that runs ``n_steps`` of the window's path (graph
        replays) from the window's last state."""
        state, make_scan, step = self.spans.last, self.tmodel.make_scan, self.step
        return lambda: make_scan(step, n_steps)(state)

    def captured_graph(self):
        from scythe_tpu_torch import graphs

        runners = list(graphs.captured(self.step).values())
        return runners[0].replay.__self__ if runners else None

    def shape(self) -> dict:
        """The sizes the yardsticks count by (the reference grid module's
        ``shape`` of the geometry), the geometry and whether the step is
        semi-implicit."""
        p = self.grid.params
        return {"geometry": p.geometry, **rgrid.geometry_module(p.geometry).shape(p),
                "semiimplicit": bool(self.model_warm.opts().get("semiimplicit"))}

    # -- the comparison -------------------------------------------------------

    def release(self):
        """Drop the program's step, graph and state (the judged interval's
        entering state moves to the host)."""
        kept = self.spans.kept
        self.kept = None if kept is None else type(kept)(
            *(t.detach().cpu() for t in kept[:5]), kept.t)
        for name in ("step", "state", "ctx", "grid"):
            setattr(self, name, None)
        self.spans.reset()
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def judge(self, device, control=None) -> dict:
        """Per-variable gaps of the run against the float64 reference:
        {"program": {check: {variable: gap}}, and with ``control`` (a
        ``harness.Reference`` in a lower precision, judged in the program's
        place on the same inputs and the same state entering the interval)
        "control"}: "warmup_gap", each variable's worst over the warm-up's
        outputs (the start included), and "interval_gap" of the judged
        interval."""
        ref_model = self.reference_model()
        names = list(ref_model.grid_params.vars)
        ref = harness.Reference(ref_model, self.phys0, torch.float64, device)
        sides = {"program": {}} if control is None else {"program": {}, "control": {}}
        st, done = ref.state0, 0
        cst = control.state0 if control is not None else None
        for n_at, path in self.warm_outputs:
            st = ref.run(st, n_at - done)
            rf = ref.fields(st)
            got = {"program": harness.read_fields(path, ref.grid)}
            if control is not None:
                cst = control.run(cst, n_at - done)
                got["control"] = control.fields(cst)
            done = n_at
            for side, f in got.items():
                g = harness.field_gaps(f, rf, names)
                if control is not None:  # the control's readings keep each output's
                    sides[side][f"warmup_gap_at_{n_at}"] = g
                prev = sides[side].get("warmup_gap", {})
                sides[side]["warmup_gap"] = {v: max(prev.get(v, 0.0), g[v]) for v in names}
        path = self.outputs[self.judged + 1]
        rf = ref.fields(ref.run(ref.from_program(self.kept), self.n_out))
        got = {"program": harness.read_fields(path, ref.grid)}
        if control is not None:
            got["control"] = control.fields(control.run(control.from_program(self.kept),
                                                        self.n_out))
        for side, f in got.items():
            sides[side]["interval_gap"] = harness.field_gaps(f, rf, names)
        return sides
