"""make_scan's captured runner (scythe_tpu_torch/graphs.py) on the CPU.

On the card ``make_scan`` runs the start-up steps eagerly and replays one
CUDA graph of the steady step.  A CUDA graph needs the card, so the runner
takes its capture primitive as a parameter, and here ``StubGraph`` stands
in for it: its capture runs the captured function once on the static
buffers, records every host read and every tensor made from host data or
written from a host value inside it (what a CUDA capture refuses), and takes
back what that run did to the buffers (its Python ran and counted its
launches, which ``trace.capturing`` holds, as in a CUDA capture); its replay
calls the function again inside a capturing block of its own whose counts
it drops, as a replay runs no Python.  Float64, inputs from a seed or the configurations' own ICs.

* The runner equals the eager loop bit for bit, and both are within 1e-9 of
  ``scythe_tpu.model.make_scan`` (each variable's max|ref|, the
  tests/test_golden.py bar) over 20-30 steps: the flagship RL slab model
  (16 cells x 16), the moist RLZ semi-implicit core (8 x 8 x 12) and the TC
  option bundle with implicit vertical diffusion (16 cells).
* The start-up steps (t = 1, 2) and the capture's warm-up step run
  eagerly; a run captures once across run_loop's output intervals; a state
  kept from one interval is unchanged after the next; the launch counters
  advance on every replay; grad, vmap, sharded steps and
  ``disable_graphs()`` stay eager; a capture that fails raises, naming its
  line, and nothing falls back: a compensated packing inside the capture
  among such failures.
* Every steady step of chip_smoke.py's capture sweep (all 21 equation
  sets, every build_step option among them) makes no host read and no host
  tensor, and its stub replay equals the eager loop bit for bit.
* The repairs the capture needed (``model.batched_solve``,
  ``common.laplacian_mask`` / ``field_of``, Smagorinsky's constants made
  once a grid) against the JAX package at 1e-12.
* The batched ensemble step (``model.batched_step``) equals its members'
  single runs at 1e-12, eager and through the stub.
"""

import contextlib
import functools
import os
import sys
import traceback
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scythe_tpu as jx
from scythe_tpu import model as jmodel
from scythe_tpu import timeintegration as jti
from scythe_tpu.physics import turbulence as jtb

import scythe_tpu_torch as tx
from scythe_tpu_torch import graphs
from scythe_tpu_torch import model as tmodel
from scythe_tpu_torch import timeintegration as tti
from scythe_tpu_torch import trace
from scythe_tpu_torch.equations import common as tcommon
from scythe_tpu_torch.examples import cha_bell_initialization as cb
from scythe_tpu_torch.examples import jw06_baroclinic_slz as jwx
from scythe_tpu_torch.examples import tc_intensification_rlz as tct
from scythe_tpu_torch.examples import williamson_sphere as wm
from scythe_tpu_torch.ops import rlz_analysis as ra
from scythe_tpu_torch.parallel import mesh as pmesh
from scythe_tpu_torch.parallel import sharding as psh
from scythe_tpu_torch.physics import turbulence as ttb

from test_torch_options import MOIST_RLZ
from test_torch_shallow_water import build_pair, initial_phys, per_var_close
from test_torch_tc_slice import ICS, KW, tcj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the card's sweep configurations, no jax in them)

torch.set_num_threads(2)
F64 = torch.float64
_TORCH_DIR = os.path.dirname(torch.__file__)


@contextlib.contextmanager
def host_ops():
    """The host reads and host-data tensors made inside the block, each with
    the innermost line outside torch that made it."""
    found = []

    def where():
        frames = [f for f in traceback.extract_stack()[:-2]
                  if not f.filename.startswith(_TORCH_DIR)]
        if not frames:
            return "?"
        f = frames[-1]
        return f"{os.path.basename(f.filename)}:{f.lineno} ({f.line})"

    def wrap(name, fn, host_data_only=False):
        def w(*a, **k):
            if not (host_data_only and a and isinstance(a[0], torch.Tensor)):
                found.append((name, where()))
            return fn(*a, **k)
        return w

    T = torch.Tensor
    setitem = T.__setitem__

    def set_item(self, idx, value):
        if not isinstance(value, torch.Tensor):
            found.append(("Tensor.__setitem__ of a host value", where()))
        return setitem(self, idx, value)

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(torch, "tensor", wrap("torch.tensor",
                                                                    torch.tensor)))
        stack.enter_context(mock.patch.object(torch, "as_tensor", wrap(
            "torch.as_tensor", torch.as_tensor, host_data_only=True)))
        stack.enter_context(mock.patch.object(torch, "from_numpy", wrap("torch.from_numpy",
                                                                        torch.from_numpy)))
        stack.enter_context(mock.patch.object(T, "__setitem__", set_item))
        for m in ("item", "tolist", "numpy", "cpu", "__float__", "__int__", "__bool__"):
            stack.enter_context(mock.patch.object(T, m, wrap(f"Tensor.{m}", getattr(T, m))))
        yield found


class StubGraph:
    """The capture primitive on the CPU (see the module docstring).  With
    ``strict`` a host op inside the capture raises, as a CUDA capture
    refuses one."""

    def __init__(self, strict=True):
        self.strict = strict
        self.captures = 0
        self.host_ops = []

    def warm(self, fn, device):
        fn()

    def capture(self, fn, device, buffers):
        saved = [b.clone() for b in buffers]
        with host_ops() as found:
            fn()  # its Python runs, its counters move, as in a CUDA capture
        for b, s in zip(buffers, saved):
            b.copy_(s)
        self.captures += 1
        self.host_ops += found
        if self.strict and found:
            raise RuntimeError(f"operation not permitted when stream is capturing: {found}")

        def replay():  # a replay runs no Python: what it counts is held, and dropped
            with trace.capturing(lambda: 0, device):
                fn()

        return replay


def stub_scan(step, n, state, stub=None):
    return graphs.scan(step, n, state, capture=stub or StubGraph())


def assert_states_equal(a, b):
    assert a.t == b.t
    for x, y in zip(a[:5], b[:5]):
        assert torch.equal(x, y)


# ------------------------------------------------ against JAX's make_scan


def _flagship(n):
    sys.path.insert(0, REPO)
    from __graft_entry__ import _flagship_model, _vortex_state

    mj = _flagship_model(num_cells=16, nl=16)
    gj = jx.create_grid(mj.grid_params, jnp.float64, matmul="plain")
    cj = jmodel.build_context(mj, gj, jnp.float64)
    sj = _vortex_state(gj, jnp.float64)
    mt = cb.flagship_model(16, 16)
    gt = tx.create_grid(mt.grid_params, F64, device="cpu")
    ct = tmodel.build_context(mt, gt, F64)
    return (mj, gj, cj, sj), (mt, gt, ct, cb.vortex_state(gt, F64))


def _moist(tmp, n):
    (mj, gj, cj), (mt, gt, ct) = build_pair(MOIST_RLZ, tmp, n)
    phys0 = initial_phys(MOIST_RLZ, gt)
    shape = (gt.nvars,) + gt.spatial_shape
    spec_j = gj.analysis(jnp.asarray(phys0))
    jmodel._set_boundary_refs(cj, gj, spec_j)
    sj = jti.initial_state(spec_j, shape, jnp.float64,
                                 imp_rows=jmodel.imp_history_rows(mj))
    spec_t = gt.analysis(torch.from_numpy(phys0))
    tmodel._set_boundary_refs(ct, gt, spec_t)
    st = tti.initial_state(spec_t, shape, F64, imp_rows=tmodel.imp_history_rows(mt))
    return (mj, gj, cj, sj), (mt, gt, ct, st)


def _tc(tmp, n):
    kw = {**KW, "t_end": n * 4.0}
    mj = tcj.build_model(str(tmp / "jax"), **kw).with_(output_interval=n * 4.0)
    gj = jx.create_grid(mj.grid_params, jnp.float64)
    tcj.write_ics(mj, gj, jmodel.build_context(mj, gj, jnp.float64).ref_state, **ICS)
    gj, cj, sj = jmodel.initialize(mj, jnp.float64)
    mt = tct.build_model(str(tmp / "torch"), **kw).with_(
        output_interval=n * 4.0, initial_conditions=mj.initial_conditions)
    assert mt.opts()["implicit_vdiff"] and mt.opts()["smagorinsky"] > 0.0
    gt, ct, st = tmodel.initialize(mt, F64, device="cpu")
    return (mj, gj, cj, sj), (mt, gt, ct, st)


@pytest.mark.parametrize("name,n", [("flagship", 30), ("moist_rlz_si", 20),
                                    ("tc_bundle_implicit_vdiff", 20)])
def test_captured_runner_is_the_eager_loop_and_jax(name, n, tmp_path):
    make = {"flagship": lambda: _flagship(n), "moist_rlz_si": lambda: _moist(tmp_path, n),
            "tc_bundle_implicit_vdiff": lambda: _tc(tmp_path, n)}[name]
    (mj, gj, cj, sj), (mt, gt, ct, st) = make()
    step = tmodel.build_step(mt, gt, ct, F64)
    eager = tmodel.make_scan(step, n)(st)
    stub = StubGraph()
    got = stub_scan(step, n, st, stub)
    assert stub.captures == 1 and stub.host_ops == []
    assert_states_equal(got, eager)
    out_j = jmodel.make_scan(jmodel.build_step(mj, gj, cj, jnp.float64), n)(sj)
    assert got.t == int(out_j.t) == n + 1
    per_var_close(gt.synthesis(got.spec)["val"], gj.synthesis(out_j.spec)["val"], 1e-9,
                  name)
    per_var_close(got.expdot_nm1, out_j.expdot_nm1, 1e-9, "expdot_nm1")


# ---------------------------------------------------------- the runner


@pytest.fixture(scope="module")
def flagship_small():
    model = cb.flagship_model(8, 16)
    grid = tx.create_grid(model.grid_params, F64, device="cpu")
    ctx = tmodel.build_context(model, grid, F64)
    return model, grid, ctx, cb.vortex_state(grid, F64)


def _step(flagship_small):
    model, grid, ctx, _ = flagship_small
    return tmodel.build_step(model, grid, ctx, F64)


def test_start_up_and_warm_up_steps_run_eagerly(flagship_small):
    inner = _step(flagship_small)
    calls = []  # (t, inside the capture or a replay)
    stub = StubGraph()
    in_graph = []

    def step(state):
        calls.append((state.t, bool(in_graph)))
        return inner(state)

    def capture(fn, device, buffers):
        in_graph.append(1)
        try:
            replay = StubGraph.capture(stub, fn, device, buffers)
        finally:
            in_graph.pop()

        def graphed():
            in_graph.append(1)
            try:
                replay()
            finally:
                in_graph.pop()
        return graphed

    stub.capture = capture
    out = stub_scan(step, 7, flagship_small[3], stub)
    # t = 1, 2 eager; t = 3 the warm-up (eager, a real step); the capture
    # records the steady step (its t the warm-up's: any t > 2 takes the same
    # branch); then 4 replays for t = 4..7, t advancing on the host
    assert calls[:3] == [(1, False), (2, False), (3, False)]
    assert calls[3] == (3, True) and len(calls) == 4 + 4
    assert all(inside for _, inside in calls[3:])
    assert out.t == 8
    (runner,) = graphs.captured(step).values()
    assert runner.replays == 4
    assert_states_equal(out, tmodel.make_scan(inner, 7)(flagship_small[3]))


def test_a_short_interval_stays_eager_until_a_steady_step(flagship_small):
    step = _step(flagship_small)
    s2 = stub_scan(step, 2, flagship_small[3])
    assert s2.t == 3 and not graphs.captured(step)
    assert stub_scan(step, 0, s2) is s2


def test_one_capture_per_run_across_output_intervals(tmp_path, monkeypatch):
    model = cb.flagship_model(8, 16)
    grid = tx.create_grid(model.grid_params, F64, device="cpu")
    cols = np.concatenate([grid.gridpoints(), cb.vortex_phys(grid).reshape(6, -1).T], axis=1)
    from scythe_tpu_torch import io as sio

    sio._write_csv(str(tmp_path / "ics.csv"), ["r", "l", *model.grid_params.vars], cols)
    model = model.with_(integration_time=36.0, output_interval=9.0,
                        initial_conditions=str(tmp_path / "ics.csv"),
                        output_dir=str(tmp_path / "graph"))
    stub = StubGraph()
    steps = []
    build = tmodel.build_step

    def keep(*a, **k):
        steps.append(build(*a, **k))
        return steps[-1]

    monkeypatch.setattr(tmodel, "build_step", keep)
    monkeypatch.setattr(graphs, "scan", functools.partial(graphs.scan, capture=stub))
    _, phys = tmodel.integrate_model(model, F64, device="cpu")
    monkeypatch.undo()
    (runner,) = graphs.captured(steps[0]).values()
    # 12 steps in 4 intervals of 3: 2 start-up + 1 warm-up, then 0 + 3 + 3 + 3
    assert stub.captures == 1 and runner.replays == 9
    assert set(os.listdir(tmp_path / "graph")) == {
        f"physical_out_{t}.csv" for t in (0.0, 9.0, 18.0, 27.0, 36.0)} | {"scythe_out.log"}
    _, ref = tmodel.integrate_model(model.with_(output_dir=str(tmp_path / "eager")), F64,
                                    device="cpu")
    assert np.array_equal(phys, ref)


def test_a_kept_state_never_changes_under_a_later_replay(flagship_small):
    step = _step(flagship_small)
    stub = StubGraph()
    first = stub_scan(step, 5, flagship_small[3], stub)
    kept = [t.clone() for t in first[:5]]
    second = stub_scan(step, 5, first, stub)
    third = stub_scan(step, 5, second, stub)
    assert stub.captures == 1 and third.t == 16
    for k, t in zip(kept, first[:5]):
        assert torch.equal(k, t)
    (runner,) = graphs.captured(step).values()
    for t in second[:5] + third[:5]:  # nothing returned shares the buffers
        assert all(t.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()
                   for b in runner.buffers)
    assert_states_equal(third, tmodel.make_scan(step, 15)(flagship_small[3]))


def _launched(names):
    return tuple(trace.process().total(k) or 0 for k in names)


def test_launch_counters_advance_on_every_replay(flagship_small):
    """A replay runs no Python: the runner adds what the capture counted,
    which the capture held, once a chunk for each of its replays."""
    inner = _step(flagship_small)
    names = ("column_solve.launches", "column_solve.backward_launches")

    def step(state):  # a wrapper that counts as a kernel's does
        trace.count(names[0], 1)
        trace.count(names[1], 2)
        return inner(state)

    n0, b0 = _launched(names)
    stub_scan(step, 6, flagship_small[3])
    assert _launched(names) == (n0 + 6, b0 + 12)
    (runner,) = graphs.captured(step).values()
    assert runner.replays == 3 and runner.counts == {names[0]: 1, names[1]: 2}
    stub_scan(step, 4, stub_scan(step, 1, flagship_small[3]))
    assert _launched(names) == (n0 + 11, b0 + 22)


def test_what_stays_eager(flagship_small, tmp_path):
    model, grid, ctx, state = flagship_small
    step = _step(flagship_small)
    stub = StubGraph()
    ref = tmodel.make_scan(step, 5)(state)
    # the CPU with the default primitive: no capture
    assert_states_equal(tmodel.make_scan(step, 5)(state), ref)
    assert not graphs.captured(step)
    # disable_graphs(), in every thread, nested
    with tmodel.disable_graphs():
        with tmodel.disable_graphs():
            assert graphs.eager_reason(step, state) == "disable_graphs()"
        assert_states_equal(stub_scan(step, 5, state, stub), ref)
    assert not graphs.graphs_disabled()
    # grad mode with a state that requires grad
    leaf = state.spec.clone().requires_grad_(True)
    out = stub_scan(step, 5, state._replace(spec=leaf), stub)
    assert out.spec.requires_grad and out.spec.grad_fn is not None
    torch.autograd.grad(out.spec.sum(), leaf)
    with torch.no_grad():
        assert graphs.eager_reason(step, state._replace(spec=leaf)) is None
    # inside a functorch transform
    specs = torch.stack([state.spec, 1.01 * state.spec])

    def member(spec):
        return stub_scan(step, 4, state._replace(spec=spec), stub).spec

    batched = torch.func.vmap(member)(specs)
    assert torch.allclose(batched[0], tmodel.make_scan(step, 4)(state).spec,
                          rtol=0.0, atol=1e-12 * float(batched[0].abs().max()))
    # a sharded step (shards as threads): marked, and its state is Sharded
    mesh = pmesh.make_mesh(2, device="cpu")
    g, c, st = psh.initialize_sharded(
        model.with_(initial_conditions=_flagship_ics(tmp_path, grid, model)), mesh, F64,
        device="cpu")
    sstep = psh.build_sharded_step(model, g, c, F64, mesh)
    assert sstep.capturable is False
    assert graphs.eager_reason(sstep, st) == "the step is marked not capturable"
    out = stub_scan(sstep, 4, st, stub)
    assert out.t == 5 and not graphs.captured(sstep)
    assert stub.captures == 0


def _flagship_ics(tmp_path, grid, model):
    from scythe_tpu_torch import io as sio

    cols = np.concatenate([grid.gridpoints(), cb.vortex_phys(grid).reshape(6, -1).T], axis=1)
    path = str(tmp_path / "ics.csv")
    sio._write_csv(path, ["r", "l", *model.grid_params.vars], cols)
    return path


def test_a_capture_error_raises_and_never_falls_back(flagship_small):
    inner = _step(flagship_small)

    def step(state):
        new = inner(state)
        if float(new.spec.abs().max()) < 0.0:  # a host read: the capture refuses it
            raise AssertionError
        return new

    with pytest.raises(graphs.GraphCaptureError, match="not permitted") as e:
        stub_scan(step, 6, flagship_small[3])
    assert "Tensor.__float__" in str(e.value)
    assert "if float(new.spec.abs().max()) < 0.0:" in str(e.value)
    assert not graphs.captured(step)

    class Broken(StubGraph):
        def capture(self, fn, device, buffers):
            fn()  # counted, and held
            raise RuntimeError("no graph today")

    def counted(state):
        trace.count("column_solve.launches", 1)
        return inner(state)

    before = _launched(("column_solve.launches",))[0]
    with pytest.raises(graphs.GraphCaptureError, match="no graph today"):
        stub_scan(counted, 6, flagship_small[3], Broken())
    # the start-up and warm-up steps' counts only: the failed capture launched nothing
    assert _launched(("column_solve.launches",))[0] == before + 3


class _CardTensor(torch.Tensor):
    """A CPU tensor that the kernels' wrappers take for a CUDA one."""

    @property
    def is_cuda(self):
        return True


def test_a_compensated_pack_inside_the_capture_names_its_line(flagship_small, monkeypatch):
    """Operators the compensated analysis packs inside the capture (a
    first-use cost the warm-up step should have paid) raise, and the capture
    names the line of ``rlz_analysis.comp_operators`` that refused them."""
    gp = tx.GridParameters(geometry="RLZ", xmin=0.0, xmax=3.0e5, num_cells=8, lDim=16,
                           zmin=0.0, zmax=1.0e4, zDim=12, vars={"a": 1, "b": 2})
    g = tx.create_grid(gp, torch.float32, matmul="compensated", device="cpu")
    inner = _step(flagship_small)
    capturing = []
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: bool(capturing))

    class Capturing(StubGraph):
        def capture(self, fn, device, buffers):
            capturing.append(True)
            try:
                return super().capture(fn, device, buffers)
            finally:
                capturing.clear()

    def step(state):  # operators made anew each step: packed anew
        ra.comp_operators(g.l_analysis, g.analysis_r.clone().as_subclass(_CardTensor),
                          g.analysis_z)
        return inner(state)

    packs = trace.process().total("rlz_analysis.packs") or 0
    with pytest.raises(graphs.GraphCaptureError,
                       match="packs its operators inside the capture") as e:
        stub_scan(step, 6, flagship_small[3], Capturing())
    assert f"{os.sep}ops{os.sep}rlz_analysis.py:" in str(e.value)
    assert "raise RuntimeError(" in str(e.value)
    assert (trace.process().total("rlz_analysis.packs") or 0) == packs + 3  # t = 1, 2, warm-up
    assert not graphs.captured(step)


def test_write_back_orders_the_history_shift():
    """The copy into the buffers reads each buffer before it is written
    over, also where the new state permutes the buffers."""
    bufs = [torch.full((3,), float(i)) for i in range(5)]
    out = (torch.full((3,), 9.0), bufs[0], bufs[1], bufs[4], bufs[3])  # a swap of 3 and 4
    graphs._write_back(bufs, out)
    assert [float(b[0]) for b in bufs] == [9.0, 0.0, 1.0, 4.0, 3.0]
    bufs = [torch.zeros(2) for _ in range(5)]
    with pytest.raises(graphs.GraphCaptureError, match="keep its state's layout"):
        graphs._write_back(bufs, (torch.zeros(3),) + tuple(bufs[1:]))


# --------------------------------------------- the card's capture sweep


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sweep"))
    return {case[0]: case for case in chip_smoke.sweep_cases(tx, tmodel, wm, jwx, tmp)}


SWEEP_LABELS = (
    "LinearAdvection1D", "LinearAdvectionRZ", "LinearAdvectionRL", "LinearAdvectionRLZ",
    "LinearShallowWater1D", "LinearShallowWaterRL", "ShallowWaterRL",
    "Oneway_ShallowWater_Slab", "Twoway_ShallowWater_Slab",
    "Twoway_ShallowWater_Slab_factored", "Twoway_ShallowWater_Slab_compensated",
    "Oneway_ShallowWater_HeightResolvedBL", "Euler_test", "BF02_test", "rainfall_test",
    "Williams2013_slabTCBL", "RL_SlabTCBL", "Kepert2017_TCBL", "MoistEulerRLZ_tc_bundle",
    "MoistEulerRLZ_compensated", "MoistEulerXYZ", "MoistEulerSLZ", "ShallowWaterSphere",
    "AdvectionSphere")


def test_the_sweep_covers_every_set_and_option(sweep):
    assert tuple(sweep) == SWEEP_LABELS
    sets = {case[1].equation_set for case in sweep.values()}
    assert sets == set(tcommon.REGISTRY) and len(sets) == 21
    opts = set()
    for case in sweep.values():
        opts |= {k for k, v in case[1].opts().items() if v}
    assert {"sponge_width", "sponge_top_width", "radiation_width", "modal_filter_tau",
            "incremental_analysis", "surface_fluxes", "implicit_vdiff", "condensation",
            "sedimentation", "smagorinsky", "semiimplicit", "si_mode",
            "hyperdiffusion_k4"} <= opts
    assert any(c[3] for c in sweep.values())  # a compensated grid
    assert any(c[1].grid_params.l_factored for c in sweep.values())


@pytest.mark.parametrize("label", SWEEP_LABELS)
def test_steady_step_makes_no_host_read(sweep, label):
    _, model, dtype, comp, phys0 = sweep[label]
    with chip_smoke.compensated_grids() if comp else contextlib.nullcontext():
        if phys0 is None:
            grid, ctx, state = tmodel.initialize(model, dtype, "cpu")
            step = tmodel.build_step(model, grid, ctx, dtype)
        else:
            grid, ctx, state, step = jwx.prepare_run(model, phys0, dtype, "cpu")
    assert grid.comp == comp
    s3 = tmodel.make_scan(step, 2)(state)
    stub = StubGraph()
    got = stub_scan(step, chip_smoke.SWEEP_STEPS, s3, stub)
    assert stub.captures == 1 and stub.host_ops == [], stub.host_ops
    assert_states_equal(got, tmodel.make_scan(step, chip_smoke.SWEEP_STEPS)(s3))
    assert all(torch.isfinite(t).all() for t in got[:5])


# ------------------------------------------------------------ the repairs


def test_batched_solve_is_jax_solve():
    """model.batched_solve (solve_ex: no check of info on the card) on the
    implicit vertical diffusion's systems against jnp.linalg.solve."""
    rng = np.random.default_rng(7)
    d = rng.normal(size=(24, 24))
    wq = 0.5 + rng.random(24)
    s = np.einsum("mi,cm,mj->cij", d, wq * (10.0 * rng.random((50, 24))), d)
    m = np.eye(24) + 4.0 * (1.0 / wq)[None, :, None] * s
    rhs = rng.normal(size=(50, 24, 7))
    got = tmodel.batched_solve(torch.from_numpy(m), torch.from_numpy(rhs)).numpy()
    want = np.asarray(jnp.linalg.solve(jnp.asarray(m), jnp.asarray(rhs)))
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    assert np.array_equal(got, torch.linalg.solve(torch.from_numpy(m),
                                                  torch.from_numpy(rhs)).numpy())


def test_laplacian_mask_and_field_of_are_what_they_replace():
    mask = tcommon.laplacian_mask(F64, "cpu")
    assert mask.shape == (9, 1, 1, 1)
    assert mask.flatten().tolist() == [1.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0]
    f = tcommon.field_of(2.5, (3, 4), torch.float32, "cpu")
    assert f.shape == (3, 4) and f.dtype == torch.float32 and bool((f == 2.5).all())
    k = torch.arange(4.0, dtype=F64, requires_grad=True)
    g = tcommon.field_of(k, (3, 4), F64, "cpu")
    assert torch.equal(g, k.detach().expand(3, 4)) and g.grad_fn is not None


@pytest.mark.parametrize("options", [{"implicit_vdiff": True},
                                     {"implicit_vdiff": True, "smagorinsky": 0.2},
                                     {"smagorinsky": 0.2, "smagorinsky_axes": "rl"}])
def test_repaired_moist_tendency_is_jax(tmp_path, options):
    """MoistEulerRLZ's tendency with the repaired mask and k_v (a constant
    K_v, and Smagorinsky's field) against the JAX package's at 1e-12."""
    from test_torch_shallow_water import assert_results_close, tendency_pair
    import dataclasses

    case = dataclasses.replace(MOIST_RLZ, options={**MOIST_RLZ.options, **options},
                               val_scale={"s": 2.0, "xi": 0.01, "mu": 0.1, "u": 5.0,
                                          "v": 5.0, "w": 2.0, "mu_c": 1e-4, "mu_r": 1e-4,
                                          "qss": 1e-4},
                               abs_vars=("mu_c", "mu_r"))
    rj, rt = tendency_pair(case, tmp_path, seed=3)
    assert_results_close(rj, rt, 1e-12)
    assert (rt.k_v is None) == (rj.k_v is None)
    if rj.k_v is not None:
        want = np.asarray(rj.k_v)
        assert np.abs(rt.k_v.numpy() - want).max() <= 1e-12 * np.abs(want).max()


def test_smagorinsky_constants_are_made_once_a_grid(tmp_path):
    (mj, gj, cj), (mt, gt, ct) = build_pair(MOIST_RLZ, tmp_path)
    rng = np.random.default_rng(5)
    shape = gt.spatial_shape
    vel = [[rng.normal(size=shape) for _ in range(3)] for _ in range(3)]
    n2 = 1e-4 + 1e-4 * rng.random(shape)
    kj = jtb.smagorinsky_viscosity(gj, 0.25, 0.2, *[[jnp.asarray(a) for a in v] for v in vel],
                                   jnp.float64, n2=jnp.asarray(n2))
    args = [[torch.from_numpy(a) for a in v] for v in vel]
    n2_t = torch.from_numpy(n2)
    k1 = ttb.smagorinsky_viscosity(gt, 0.25, 0.2, *args, F64, n2=n2_t)
    made = dict(gt.smag_consts)
    with host_ops() as found:
        k2 = ttb.smagorinsky_viscosity(gt, 0.25, 0.2, *args, F64, n2=n2_t)
    assert found == [] and gt.smag_consts.keys() == made.keys()
    assert all(gt.smag_consts[k] is made[k] for k in made)
    want = np.asarray(kj)
    assert torch.equal(k1, k2)
    assert np.abs(k2.numpy() - want).max() <= 1e-12 * np.abs(want).max()


# ------------------------------------------------------------ ensembles


def test_batched_step_equals_single_runs(flagship_small):
    model, grid, ctx, state = flagship_small
    step = _step(flagship_small)
    base = cb.vortex_phys(grid)
    ics = torch.as_tensor(np.stack([base * (1.0 + i / 100.0) for i in range(3)]))
    bstate = tmodel.ensemble_state(torch.func.vmap(grid.analysis)(ics), ics.shape)
    bstep = tmodel.batched_step(step)
    eager = tmodel.make_scan(bstep, 8)(bstate)
    stub = StubGraph()
    got = stub_scan(bstep, 8, bstate, stub)
    assert stub.captures == 1 and stub.host_ops == []
    assert_states_equal(got, eager)
    for i in range(3):
        one = tmodel.make_scan(step, 8)(tti.initial_state(
            grid.analysis(ics[i]), ics[i].shape, F64))
        for x, y in zip(got[:5], one[:5]):
            assert (x[i] - y).abs().max() <= 1e-12 * y.abs().max()


def test_ensemble_state_is_initial_state_of_each_member():
    spec = torch.randn(2, 3, 5, dtype=F64)
    st = tmodel.ensemble_state(spec, (2, 3, 4, 6), imp_rows=2)
    one = tti.initial_state(spec[0], (3, 4, 6), F64, imp_rows=2)
    assert st.t == one.t == 1
    for x, y in zip(st[1:5], one[1:5]):
        assert x.shape == (2,) + y.shape and not x.any()
    assert st.expdot_nm1 is st.expdot_nm2 and st.impdot_nm1 is not st.expdot_nm1
