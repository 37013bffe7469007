"""The published-benchmark examples of the port (scythe_tpu_torch/examples:
linear_advection_example, warm_bubble, straka_density_current,
inertia_gravity_wave, bf02_moist_benchmark, galewsky_instability,
analyze_tc) and its model configs (scythe_tpu_torch/models) against the
JAX package's examples/ and models/, float64 on the CPU.

Tolerances, relative to each field's or column's max|ref|: builders, IC
files, reference profiles and diagnostics 1e-12; short runs (20-50 steps at
a small grid, and the linear-advection walk-through's one period) 1e-9;
analyze_tc's table and spectrum print alike; the configs' ModelParameters
equal field by field.
"""

import dataclasses
import enum
import importlib.util
import os
import runpy
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scythe_tpu as jx
from scythe_tpu import model as jmodel

import scythe_tpu_torch as tx
from scythe_tpu_torch import model as tmodel
from scythe_tpu_torch import timeintegration as tti
from scythe_tpu_torch.examples import analyze_tc as tat
from scythe_tpu_torch.examples import bf02_moist_benchmark as tbf
from scythe_tpu_torch.examples import cha_bell_initialization as cb
from scythe_tpu_torch.examples import galewsky_instability as tgw
from scythe_tpu_torch.examples import inertia_gravity_wave as tigw
from scythe_tpu_torch.examples import linear_advection_example as tla
from scythe_tpu_torch.examples import straka_density_current as tst
from scythe_tpu_torch.examples import warm_bubble as twb
from scythe_tpu_torch.physics import thermodynamics as td

torch.set_num_threads(2)
F64 = torch.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_jax_example", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jst = _jax_example("straka_density_current")
jigw = _jax_example("inertia_gravity_wave")
jbf = _jax_example("bf02_moist_benchmark")
jgw = _jax_example("galewsky_instability")


def rel_close(got, ref, tol, what="", scales=None):
    """Each leading-axis row of ``got`` within ``tol`` of its ``ref``'s
    max (absolutely where that row is zero), or of ``scales[i]`` where
    given."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    for i in range(ref.shape[0]):
        scale = (scales or {}).get(i, np.abs(ref[i]).max())
        err = np.abs(got[i] - ref[i]).max()
        assert err <= tol * (scale if scale > 0 else 1.0), (what, i, err, scale)


def csv_close(got_path, ref_path, tol=1e-12, scales=None):
    """Two CSV files of one schema, column by column (``scales``: {column
    name: the scale its error is held against})."""
    with open(got_path) as f, open(ref_path) as g:
        names = f.readline().strip().split(",")
        assert g.readline().strip().split(",") == names
    rel_close(np.loadtxt(got_path, delimiter=",", skiprows=1).T,
              np.loadtxt(ref_path, delimiter=",", skiprows=1).T, tol, got_path,
              {names.index(k): v for k, v in (scales or {}).items()})


def config(obj, base=None):
    """A ModelParameters / GridParameters as plain values: enums by name,
    paths under ``base`` relative to it, so the two packages' compare."""
    if dataclasses.is_dataclass(obj):
        return {f.name: config(getattr(obj, f.name), base) for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.name
    if isinstance(obj, (tuple, list)):
        return [config(v, base) for v in obj]
    if isinstance(obj, dict):
        return {k: config(v, base) for k, v in obj.items()}
    if isinstance(obj, str) and base and os.path.abspath(obj).startswith(str(base)):
        return os.path.relpath(os.path.abspath(obj), base)
    return obj


def jax_fields(model, n_steps):
    grid, ctx, state = jmodel.initialize(model, jnp.float64)
    state = jmodel.make_scan(jmodel.build_step(model, grid, ctx, jnp.float64), n_steps)(state)
    return np.asarray(grid.synthesis(state.spec)["val"])


def port_fields(model, n_steps):
    grid, ctx, state = tmodel.initialize(model, F64, device="cpu")
    state = tmodel.make_scan(tmodel.build_step(model, grid, ctx, F64), n_steps)(state)
    return grid.synthesis(state.spec)["val"].numpy()


def contexts(jmod_model, tmod_model):
    """(JAX grid, JAX ctx, port grid, port ctx) in float64 (the port's on
    the CPU)."""
    jg = jx.create_grid(jmod_model.grid_params, jnp.float64)
    tg = tx.create_grid(tmod_model.grid_params, F64, device="cpu")
    return (jg, jmodel.build_context(jmod_model, jg, jnp.float64),
            tg, tmodel.build_context(tmod_model, tg, F64))


# ---------------------------------------------------------------------------
# linear advection and the warm bubble: the JAX scripts' main() as they run


def test_linear_advection_walk_through_matches_jax(tmp_path, monkeypatch):
    """The JAX main's one period (2,000 steps, outputs at 0, 50, 100 s)
    against the port's run: the IC file at 1e-12, every output at 1e-9."""
    monkeypatch.chdir(tmp_path)
    _jax_example("linear_advection_example").main()
    l2 = tla.run(str(tmp_path / "port"), F64, "cpu")
    jdir = tmp_path / "linear_advection_test"
    csv_close(tmp_path / "port" / "1d_linear_advection_test_ics.csv",
              tmp_path / "1d_linear_advection_test_ics.csv")
    for t in ("0.0", "50.0", "100.0"):
        csv_close(tmp_path / "port" / f"physical_out_{t}.csv",
                  jdir / f"physical_out_{t}.csv", 1e-9)
    assert l2 < 1e-2  # the walk-through's "should be small" (JAX: ~6e-4)


def test_warm_bubble_matches_jax(tmp_path, monkeypatch):
    """The JAX main with its integrate_model cut to 30 steps: its sounding
    and IC file against the port's builders (1e-12), its 30 steps against
    the port's (1e-9), and the readings it prints against the port's."""
    jwb = _jax_example("warm_bubble")
    import scythe_tpu
    import scythe_tpu.utils.runtime as jrt

    ran = {}

    def cut(model, **kw):
        ran["given"] = model
        ran["model"] = model.with_(integration_time=3.0, output_interval=3.0)
        ran["out"] = scythe_tpu.model.integrate_model(ran["model"], write_outputs=False)
        return ran["out"]

    monkeypatch.setattr(scythe_tpu, "integrate_model", cut)
    monkeypatch.setattr(jrt, "enable_compile_cache", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["warm_bubble.py", "--cpu"])
    monkeypatch.chdir(tmp_path)
    jwb.main()
    model = twb.build_model(str(tmp_path / "port"), t_end=3.0)
    twb.write_ics(model)
    jm = ran["model"]
    assert config(model, tmp_path / "port") == config(
        ran["given"].with_(integration_time=3.0), tmp_path / "warm_bubble_out")
    csv_close(model.initial_conditions, jm.initial_conditions)
    with open(model.ref_state_file) as f, open(jm.ref_state_file) as g:
        assert f.read() == g.read()
    grid, phys = tx.integrate_model(model, dtype=F64, write_outputs=False, device="cpu")
    jgrid, jphys = ran["out"]
    rel_close(phys, np.asarray(jphys), 1e-9)
    w = np.asarray(jphys)[4]
    s = np.asarray(jphys)[0].reshape(jgrid.spatial_shape)
    zc = (s * np.asarray(jgrid.z_mish)[None, :]).sum() / s.sum()
    got = twb.readings(grid, phys)
    assert abs(got[0] - w.max()) <= 1e-9 * abs(w.max())
    assert abs(got[1] - zc) <= 1e-9 * zc


# ---------------------------------------------------------------------------
# Straka, SK94, BF02: builders, ICs, diagnostics, short runs


@pytest.mark.parametrize("pkg", ["straka", "igw"])
def test_dry_builders_and_ics_match_jax(tmp_path, pkg):
    """build_model (every field), the sounding, write_ics and the theta'
    diagnostics at 1e-12; the SK94 base state, analytic solution and energy
    centroid at 1e-12; Straka's front on the same theta'.  theta' and the
    ICs' s' are differences of values up to ~4000x their own size (SK94's
    0.01 K), so their errors are held at 1e-12 of theta's and the entropy's
    scales.  The ICs' s' is
    entropy(T', rho') - sbar, held against max|sbar|."""
    jmod, tmod, size = {"straka": (jst, tst, (16, 12, 0.25, 900.0)),
                        "igw": (jigw, tigw, (20, 12, 0.75, 3000.0))}[pkg]
    jm = jmod.build_model(str(tmp_path / "jax"), *size)
    tm = tmod.build_model(str(tmp_path / "port"), *size)
    assert config(tm, tmp_path / "port") == config(jm, tmp_path / "jax")
    with open(tm.ref_state_file) as f, open(jm.ref_state_file) as g:
        assert f.read() == g.read()
    jg, jc, tg, tc = contexts(jm, tm)
    jmod.write_ics(jm, jg, jc.ref_state)
    tmod.write_ics(tm, tg, tc.ref_state)
    csv_close(tm.initial_conditions, jm.initial_conditions,
              scales={"s": np.abs(tst.ref_columns(tc.ref_state)[0]).max()})
    rng = np.random.default_rng(0)
    phys = rng.normal(size=(5,) + tg.spatial_shape) * 0.01
    thp = tmod.theta_pert(phys, tg, tc.ref_state)
    # theta' = theta - theta_bar: held against the scale of theta itself
    theta_bar = td.on_host(td.potential_temperature, *tst.ref_columns(tc.ref_state))
    assert (np.abs(thp - jmod.theta_pert(phys, jg, jc.ref_state)).max()
            <= 1e-12 * theta_bar.max())
    if pkg == "straka":
        cold = -5.0 * np.exp(-((tg.r_mish[:, None] / 8000.0) ** 2)) * np.ones_like(thp)
        assert tst.front_location(cold, tg) == jst.front_location(cold, jg) > 0.0
    else:
        for a, b in zip(tigw.base_state(tc.ref_state), jigw.base_state(jc.ref_state)):
            rel_close(a[None], np.asarray(b)[None], 1e-12)
        an = tigw.analytic_theta_pert(tg, 1234.0)
        rel_close(an, jigw.analytic_theta_pert(jg, 1234.0), 1e-12)
        assert abs(tigw.energy_centroid_x(an, tg) - jigw.energy_centroid_x(an, jg)) <= 1e-12 * tigw.LX


@pytest.mark.parametrize("pkg", ["straka", "igw"])
def test_dry_examples_twenty_steps_match_jax(tmp_path, pkg):
    """20 steps of each package from its own example's files, 1e-9."""
    jmod, tmod, size = {"straka": (jst, tst, (16, 12, 0.25, 5.0)),
                        "igw": (jigw, tigw, (20, 12, 0.75, 15.0))}[pkg]
    jm = jmod.build_model(str(tmp_path / "jax"), *size)
    tm = tmod.build_model(str(tmp_path / "port"), *size)
    jg, jc, tg, tc = contexts(jm, tm)
    jmod.write_ics(jm, jg, jc.ref_state)
    tmod.write_ics(tm, tg, tc.ref_state)
    rel_close(port_fields(tm, 20), jax_fields(jm, 20), 1e-9)


def test_straka_snapshots_and_readings(tmp_path):
    """snapshots cuts the run into its parts (t = 0 and each part's end) as
    the JAX test's fixture does, and readings gives the test's numbers."""
    tm = tst.build_model(str(tmp_path), 16, 12, 0.25, 6.0)
    tg = tx.create_grid(tm.grid_params, F64, device="cpu")
    tst.write_ics(tm, tg, tmodel.build_context(tm, tg, F64).ref_state)
    grid, ctx, runs = tst.snapshots(tm, 3, F64, "cpu")
    assert [t for t, _ in runs] == [0.0, 2.0, 4.0, 6.0]
    rel_close(runs[-1][1], port_fields(tm, 24), 1e-12)
    r = tst.readings(grid, ctx.ref_state, runs)
    thp = tst.theta_pert(runs[-1][1], grid, ctx.ref_state)
    assert r["theta_min_K"][-1] == thp.min() and r["front_m"][-1] == tst.front_location(thp, grid)


@pytest.fixture(scope="module")
def bf02_pair(tmp_path_factory):
    """The BF02 example at 8 cells x 12 levels (ts 0.25 s, 5 s) built by each
    package under its own directory, ICs written: (port model, JAX model,
    JAX grid, JAX ctx, port grid, port ctx, base directory)."""
    base = tmp_path_factory.mktemp("bf02")
    kw = dict(num_cells=8, zdim=12, ts=0.25, t_end=5.0)
    tm = tbf.build_model(str(base / "port"), **kw)
    jm = jbf.build_model(str(base / "jax"), **kw)
    jg, jc, tg, tc = contexts(jm, tm)
    jbf.write_ics(jm, jg, jc.ref_state)
    tbf.write_ics(tm, tg, tc.ref_state)
    return tm, jm, jg, jc, tg, tc, base


def test_bf02_profiles_and_builders_match_jax(bf02_pair):
    """_theta_e_sat, _solve_T, base_state_profiles (to 3 km),
    write_reference_file, build_model, write_ics and diagnostics at 1e-12."""
    T = np.array([280.0, 290.0, 300.0])
    p = np.array([700.0, 850.0, 1000.0])
    rel_close(tbf._theta_e_sat(T, p)[None], jbf._theta_e_sat(T, p)[None], 1e-12)
    rel_close(tbf._solve_T(p, 330.0)[None], jbf._solve_T(p, 330.0)[None], 1e-12)
    zpts = np.linspace(0.0, 3000.0, 7)
    prof, jprof = tbf.base_state_profiles(zpts), jbf.base_state_profiles(zpts)
    assert sorted(prof) == sorted(jprof)
    rel_close(np.stack([prof[k] for k in sorted(prof)]),
              np.stack([np.asarray(jprof[k]) for k in sorted(prof)]), 1e-12)
    tm, jm, jg, jc, tg, tc, base = bf02_pair
    assert config(tm, base / "port") == config(jm, base / "jax")
    rel_close(np.loadtxt(tm.ref_state_file).T, np.loadtxt(jm.ref_state_file).T, 1e-12)
    csv_close(tm.initial_conditions, jm.initial_conditions)
    phys = tx.io.read_physical_grid(tm.initial_conditions, tg)
    got = tbf.diagnostics(tg, tc.ref_state, phys)
    want = jbf.diagnostics(jg, jc.ref_state, phys)
    rel_close(np.array(got)[:, None], np.array(want)[:, None], 1e-12)
    assert 1.8 < got[1] < 2.1  # the +2 K theta_rho' bubble


def test_bf02_twenty_steps_match_jax(bf02_pair):
    """20 BF02 steps (exact reference state, diagnostic condensation, the
    modal filter) of each package from its own files, 1e-9; simulate's
    rows are the diagnostics of its snapshots."""
    tm, jm, jg, jc, tg, tc, _ = bf02_pair
    ref = jax_fields(jm, 20)
    rel_close(port_fields(tm, 20), ref, 1e-9)
    grid, ctx, rows = tbf.simulate(tm, F64, "cpu", report_every=2.5)
    assert [t for t, _ in rows] == [0.0, 2.5, 5.0]
    rel_close(np.array(rows[-1][1])[:, None],
              np.array(jbf.diagnostics(jg, jc.ref_state, ref))[:, None], 1e-9)


# ---------------------------------------------------------------------------
# Galewsky


def test_galewsky_initial_state_matches_jax():
    """u_jet, balanced_height and bump at 1e-12 of their max."""
    phi = np.linspace(-1.5, 1.5, 301)
    lam = np.linspace(0.0, 2 * np.pi, 301)
    rel_close(np.stack([tgw.u_jet(phi), tgw.balanced_height(phi), tgw.bump(phi, lam)]),
              np.stack([jgw.u_jet(phi), jgw.balanced_height(phi), jgw.bump(phi, lam)]), 1e-12)


def test_galewsky_short_run_matches_jax():
    """The JAX main's set-up (grid, ts from the pole-ring CFL, ICs) at 16
    cells, 30 steps in float64 against the port's grid, initial_fields and
    step (run_days' chain), 1e-9."""
    cells = 16
    gp = jx.GridParameters(geometry="SL", xmin=-np.pi / 2, xmax=np.pi / 2, num_cells=cells,
                           lDim=4 * cells, sphere_radius=jgw.A_EARTH,
                           vars={"h": 1, "u": 2, "v": 3})
    ts = round(0.6 * jgw.A_EARTH * np.sin(0.1127 * np.pi / cells)
               / np.sqrt(jgw.G * 10000.0))
    jm = jx.ModelParameters(ts=float(ts), integration_time=86400.0, output_interval=86400.0,
                            equation_set="ShallowWaterSphere", initial_conditions="unused",
                            output_dir="/unused", grid_params=gp,
                            physical_params={"g": jgw.G, "Omega": jgw.OMEGA, "K": 2.0e4})
    tm = tgw.build_model(cells, 1)
    assert config(tm.grid_params) == config(gp)
    assert (tm.ts, tm.equation_set, tm.phys()) == (jm.ts, jm.equation_set, jm.phys())
    jg = jx.create_grid(gp, jnp.float64)
    pts = jg.gridpoints()
    phi = pts[:, 0].reshape(jg.spatial_shape)
    lam = pts[:, 1].reshape(jg.spatial_shape)
    phys0 = np.stack([jgw.balanced_height(phi) + jgw.bump(phi, lam), jgw.u_jet(phi),
                      np.zeros_like(phi)])
    from scythe_tpu import timeintegration as jti

    state = jti.initial_state(jg.analysis(jnp.asarray(phys0)), phys0.shape, jnp.float64)
    step = jmodel.build_step(jm, jg, jmodel.build_context(jm, jg, jnp.float64), jnp.float64)
    ref = np.asarray(jg.synthesis(jmodel.make_scan(step, 30)(state).spec)["val"])
    tg = tx.create_grid(tm.grid_params, torch.float64, device="cpu")
    tphys0 = tgw.initial_fields(tg)
    rel_close(tphys0, phys0, 1e-12)
    tstate = tti.initial_state(tg.analysis(torch.from_numpy(tphys0)), tphys0.shape,
                               torch.float64)
    tstep = tmodel.build_step(tm, tg, tmodel.build_context(tm, tg, torch.float64),
                              torch.float64)
    out = tg.synthesis(tmodel.make_scan(tstep, 30)(tstate).spec)["val"].numpy()
    rel_close(out, ref, 1e-9)
    dev = ref[0] - ref[0].mean(axis=1, keepdims=True)
    energy, u_max, finite = tgw.day_readings(out)
    assert finite and abs(energy - (dev**2).mean()) <= 1e-9 * energy
    assert abs(u_max - ref[1].max()) <= 1e-9 * u_max


# ---------------------------------------------------------------------------
# analyze_tc on a short two-layer run


CONFIG = """
from {pkg} import BC, GridParameters, ModelParameters

model = ModelParameters(
    ts=3.0, integration_time=60.0, output_interval=30.0,
    equation_set="Twoway_ShallowWater_Slab",
    initial_conditions=r"{ics}", output_dir=r"{out}",
    grid_params=GridParameters(
        geometry="RL", xmin=0.0, xmax=3.0e5, num_cells=12, lDim=16,
        BCL={{"h": BC.R1T1, "u": BC.R1T0, "v": BC.R1T0, "ub": BC.R1T0, "vb": BC.R1T0,
              "wb": BC.R1T1}},
        BCR={{"h": BC.R0, "u": BC.R1T1, "v": BC.R0, "ub": BC.R1T1, "vb": BC.R0, "wb": BC.R0}},
        vars={{"h": 1, "u": 2, "v": 3, "ub": 4, "vb": 5, "wb": 6}}),
    physical_params={{"g": 9.81, "K": 5000.0, "Cd": 2.4e-3, "Hfree": 2000.0, "Hb": 1000.0,
                      "f": 5.0e-5, "S1": 1.0e-5}})
"""


def test_analyze_tc_prints_what_jax_prints(tmp_path, monkeypatch, capsys):
    """A 20-step two-way run written by the port (outputs at 0, 30, 60 s):
    the intensity table and the vorticity spectrum printed by both
    packages' scripts alike, and the E-MPI of a sounding."""
    out = tmp_path / "run"
    for pkg in ("scythe_tpu", "scythe_tpu_torch"):
        (tmp_path / f"{pkg}.py").write_text(
            CONFIG.format(pkg=pkg, ics=tmp_path / "ics.csv", out=out))
    model = runpy.run_path(str(tmp_path / "scythe_tpu_torch.py"))["model"]
    grid = tx.create_grid(model.grid_params, F64, device="cpu")
    cb.write_rankine_ics(grid, model.initial_conditions)
    tx.integrate_model(model, dtype=F64, device="cpu")
    snd = tmp_path / "snd.txt"
    with open(snd, "w") as f:
        f.write("1015.0 300.0 18.0\n")
        for z in np.linspace(500.0, 20000.0, 40):
            f.write(f"{z} {300.0 + 0.004 * z} {18.0 * np.exp(-z / 2500.0)}\n")
    jat = _jax_example("analyze_tc")
    printed = {}
    for name, main, cfg in (("jax", jat.main, "scythe_tpu.py"),
                            ("port", lambda: tat.main([*sys.argv[1:], "--cpu"]),
                             "scythe_tpu_torch.py")):
        monkeypatch.setattr(sys, "argv", ["analyze_tc.py", str(out), "--model",
                                          str(tmp_path / cfg), "--empi-sounding",
                                          str(snd), "--vmax", "40"])
        main()
        printed[name] = capsys.readouterr().out
    lines = printed["port"].splitlines()
    assert lines == printed["jax"].splitlines()
    assert sum(ln.strip().startswith(("0 ", "30 ", "60 ")) for ln in lines) == 3
    assert any(ln.startswith("E-MPI of") for ln in lines) and "k=5" in lines[-1]


def test_analyze_tc_reads_the_ports_twoway_config():
    """The default --model is the port's copy of
    models/cha_bell2024/twoway.py."""
    assert os.path.samefile(tat.DEFAULT_MODEL, os.path.join(
        REPO, "scythe_tpu_torch", "models", "cha_bell2024", "twoway.py"))


# ---------------------------------------------------------------------------
# the model configs


MODELS = ["linear_advection_1d.py", "moist_euler_rlz_demo.py", "tc_mature_rlz.py",
          "williamson2_sphere.py", "cha_bell2024/common.py", "cha_bell2024/oneway.py",
          "cha_bell2024/oneway_spinup.py", "cha_bell2024/twoway.py",
          "cha_bell2024/twoway_tpu.py"]


@pytest.mark.parametrize("name", MODELS)
def test_model_configs_equal_the_jax_ones(tmp_path, monkeypatch, name):
    """Each config file, run as the CLI runs it (runpy), defines what the JAX
    package's does: ModelParameters equal field by field (common.py: GRID and
    PHYSICS); tc_mature_rlz.py writes its ICs where they are missing."""
    out = {}
    for pkg, root in (("jax", os.path.join(REPO, "models")),
                      ("port", os.path.join(REPO, "scythe_tpu_torch", "models"))):
        os.makedirs(tmp_path / pkg)
        monkeypatch.chdir(tmp_path / pkg)
        ns = runpy.run_path(os.path.join(root, name))
        out[pkg] = ({"GRID": config(ns["GRID"]), "PHYSICS": ns["PHYSICS"]}
                    if name.endswith("common.py") else config(ns["model"]))
        if name == "tc_mature_rlz.py":
            assert os.path.exists(ns["model"].initial_conditions)
        if name == "williamson2_sphere.py":
            ns["write_ics"](str(tmp_path / f"{pkg}_w2.csv"))
    assert out["port"] == out["jax"]
    if name == "williamson2_sphere.py":
        csv_close(tmp_path / "port_w2.csv", tmp_path / "jax_w2.csv")
