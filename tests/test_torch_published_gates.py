"""The JAX test suite's model-level gates, run on the port at the JAX
tests' own sizes and held to their bands, float64 on the CPU:

* test_euler_semiimplicit.py:82, the Euler_test warm bubble rises (RZ 25 x
  40, ts 0.15 s, 90 s);
* test_moist.py:68, the BF02_test moist bubble rises (RZ 20 x 30, ts 0.1 s,
  30 s);
* test_convergence.py:166, LinearShallowWater1D converges to the analytic
  travelling wave faster than order 2.5 (16 and 32 cells), and :250, the
  Euler_test acoustic standing mode oscillates at sqrt(Pxi_bar) k (15%);
* test_conservation.py:16, periodic linear shallow water: mass to 1e-10,
  energy within +0.1% / -7% over 1,000 steps;
* test_zbc_grid.py:9, per-variable vertical boundary conditions of the
  analysis;
* test_advection_2d.py:9 and :47, LinearAdvectionRL half a revolution and
  LinearAdvectionRZ translation (8% rms);
* test_smagorinsky.py:98, the XYZ moist bubble with the Smagorinsky closure
  (300 steps) rises and does not outgrow the constant-K run.

The configurations and IC files are the JAX tests' own (their helpers),
converted to the port's parameters.
"""

import dataclasses

import numpy as np
import torch

import scythe_tpu_torch as tx
from scythe_tpu_torch import model as tmodel
from scythe_tpu_torch import timeintegration as tti
from scythe_tpu_torch.basis import bspline

import test_euler_semiimplicit as jeu
import test_moist as jmo
import test_xyz as jxyz
from test_torch_sharding import port_model, port_params

torch.set_num_threads(2)
F64 = torch.float64


def run(model):
    _, phys = tx.integrate_model(model, dtype=F64, write_outputs=False, device="cpu")
    return phys


def test_euler_warm_bubble_rises(tmp_path):
    """test_euler_semiimplicit.py:82."""
    jm = jeu._euler_model(tmp_path, semiimplicit=True, ts=0.15, T=90.0)
    jeu._write_ics(jm, bubble_amp=2.0)
    phys = run(port_model(jm))
    w = phys[4]
    assert np.isfinite(phys).all()
    assert w.max() > 0.05
    assert w.max() < 50.0


def test_bf02_moist_bubble(tmp_path):
    """test_moist.py:68."""
    jm = jmo._moist_model(tmp_path, "BF02_test",
                          {"s": 1, "xi": 2, "mu": 3, "u": 4, "w": 5, "mu_l": 6, "qss": 7},
                          ts=0.1)
    jmo._write_bubble_ics(jm)
    phys = run(port_model(jm))
    assert np.isfinite(phys).all()
    assert phys[4].max() > 0.01


def _write_ics(path, names, pts, cols):
    tx.io._write_csv(str(path), names, np.concatenate([pts, np.stack(cols, 1)], 1))


def _sw1d_error(tmp_path, num_cells, ts):
    """test_convergence.py's _sw1d_error on the port."""
    g, H, A = 9.81, 10.0, 0.01
    c = np.sqrt(g * H)
    Lx = 1000.0
    k = 2 * np.pi / Lx * 2
    T = Lx / (2 * c)
    gp = tx.GridParameters(geometry="R", xmin=0.0, xmax=Lx, num_cells=num_cells,
                           BCL={"h": tx.BC.PERIODIC, "u": tx.BC.PERIODIC},
                           BCR={"h": tx.BC.PERIODIC, "u": tx.BC.PERIODIC},
                           vars={"h": 1, "u": 2})
    n_steps = int(round(T / ts))
    model = tx.ModelParameters(
        ts=ts, integration_time=n_steps * ts, output_interval=n_steps * ts,
        equation_set="LinearShallowWater1D",
        initial_conditions=str(tmp_path / f"ics{num_cells}.csv"),
        output_dir=str(tmp_path / f"out{num_cells}"), grid_params=gp,
        physical_params={"g": g, "K": 0.0, "H": H})
    x = tx.create_grid(gp, F64, device="cpu").r_mish
    _write_ics(model.initial_conditions, ["r", "h", "u"], x[:, None],
               [A * np.sin(k * x), g * A / c * np.sin(k * x)])
    phys = run(model)
    return np.abs(phys[0] - A * np.sin(k * (x - c * n_steps * ts))).max() / A


def test_sw1d_manufactured_convergence(tmp_path):
    """test_convergence.py:166."""
    e1 = _sw1d_error(tmp_path, 16, ts=0.2)
    e2 = _sw1d_error(tmp_path, 32, ts=0.1)
    order = np.log2(e1 / e2)
    assert e2 < e1, (e1, e2)
    assert order > 2.5, (e1, e2, order)
    assert e2 < 5e-3, e2


def test_euler_acoustic_mode_frequency(tmp_path):
    """test_convergence.py:250: the radial-wavenumber-1 standing mode of a
    closed RZ box at sqrt(Pxi_bar) * k within 15%."""
    Lr, Lz = 10000.0, 10000.0
    gp = tx.GridParameters(geometry="RZ", xmin=0.0, xmax=Lr, num_cells=16, zmin=0.0,
                           zmax=Lz, zDim=20,
                           BCL={"u": tx.BC.R1T0, "w": tx.BC.R1T1}, BCR={"u": tx.BC.R1T0},
                           vars={"s": 1, "xi": 2, "mu": 3, "u": 4, "w": 5})
    zs = np.linspace(0.0, Lz * 1.2, 50)
    theta = 300.0 + 0.004 * zs
    sounding = tmp_path / "sounding.txt"
    with open(sounding, "w") as f:
        f.write(f"1015.0 {theta[0]} 0.0\n")
        for z, th in zip(zs[1:], theta[1:]):
            f.write(f"{z} {th} 0.0\n")
    ts = 0.1
    model = tx.ModelParameters(
        ts=ts, integration_time=30 * ts, output_interval=ts, equation_set="Euler_test",
        initial_conditions=str(tmp_path / "ics.csv"), output_dir=str(tmp_path / "out"),
        ref_state_file=str(sounding), grid_params=gp, physical_params={"K": 0.0},
        options={"semiimplicit": True})
    pts = tx.create_grid(gp, F64, device="cpu").gridpoints()
    k = np.pi / Lr
    zero = np.zeros(len(pts))
    _write_ics(model.initial_conditions, ["r", "z", "s", "xi", "mu", "u", "w"], pts,
               [zero, 1e-5 * np.cos(k * pts[:, 0]), zero, zero, zero])
    grid, ctx, state = tmodel.initialize(model, F64, device="cpu")
    scan10 = tmodel.make_scan(tmodel.build_step(model, grid, ctx, F64), 10)
    cs = float(np.sqrt(float(ctx.ref_state.Pxi_bar)))
    period_expect = 2 * np.pi / (cs * k)
    amps = []
    for _ in range(int(1.5 * period_expect / (10 * ts))):
        state = scan10(state)
        u = grid.synthesis(state.spec)["val"][3][:, 10].numpy()
        amps.append(np.sum(u * np.sin(k * grid.r_mish)))
    crossings = np.where(np.diff(np.sign(np.asarray(amps))) != 0)[0]
    assert len(crossings) >= 2, "mode did not oscillate"
    got = 2 * np.pi / (2.0 * np.diff(crossings).mean() * 10 * ts)
    want = cs * k
    assert abs(got - want) / want < 0.15, (got, want)


def test_periodic_sw_mass_and_energy():
    """test_conservation.py:16."""
    gp = tx.GridParameters(geometry="R", xmin=0.0, xmax=1000.0, num_cells=64,
                           BCL={"h": tx.BC.PERIODIC, "u": tx.BC.PERIODIC},
                           BCR={"h": tx.BC.PERIODIC, "u": tx.BC.PERIODIC},
                           vars={"h": 1, "u": 2})
    g_, H = 9.81, 100.0
    model = tx.ModelParameters(ts=0.05, integration_time=50.0, output_interval=50.0,
                               equation_set="LinearShallowWater1D", grid_params=gp,
                               physical_params={"g": g_, "K": 0.0, "H": H})
    grid = tx.create_grid(gp, F64, device="cpu")
    step = tmodel.build_step(model, grid, tmodel.build_context(model, grid, F64), F64)
    r = grid.r_mish
    h0 = np.exp(-(((r - 500.0) / 80.0) ** 2))
    phys0 = torch.from_numpy(np.stack([h0, np.zeros_like(h0)]))
    state = tti.initial_state(grid.analysis(phys0), (2,) + grid.spatial_shape, F64)
    w = bspline.mish_weights(0.0, 1000.0, 64)

    def diag(st):
        f = grid.synthesis(st.spec)["val"].numpy()
        return np.sum(w * f[0]), np.sum(w * (g_ * f[0] * f[0] + H * f[1] * f[1])) / 2.0

    m0, e0 = diag(state)
    scan = tmodel.make_scan(step, 100)
    masses, energies = [], []
    for _ in range(10):
        state = scan(state)
        m, e = diag(state)
        masses.append(m)
        energies.append(e)
    assert np.abs(np.asarray(masses) - m0).max() < 1e-10 * abs(m0)
    energies = np.asarray(energies)
    assert energies.max() < e0 * 1.001
    assert energies.min() > e0 * 0.93, energies.min() / e0


def test_per_variable_z_bcs():
    """test_zbc_grid.py:9: w = 0 at both boundaries of its column fit, s
    unconstrained."""
    gp = tx.GridParameters(geometry="RZ", xmin=0.0, xmax=10.0, num_cells=4, zmin=0.0,
                           zmax=1.0, zDim=20, BCB={"w": tx.ZBC.R1T0},
                           BCT={"w": tx.ZBC.R1T0}, vars={"s": 1, "w": 2})
    g = tx.create_grid(gp, F64, device="cpu")
    f = torch.from_numpy(np.random.default_rng(0).normal(size=(2,) + g.spatial_shape))
    acoef = torch.einsum("vkz,vrz->vrk", g.analysis_z, f).numpy()
    k = np.arange(gp.zDim)
    bottom, top = (-1.0) ** k, np.ones(gp.zDim)
    for v, name in enumerate(gp.vars):
        if name == "w":
            assert np.abs(acoef[v] @ bottom).max() < 1e-10
            assert np.abs(acoef[v] @ top).max() < 1e-10
        else:
            assert np.abs(acoef[v] @ bottom).max() > 1e-3


def test_rl_solid_body_rotation(tmp_path):
    """test_advection_2d.py:9: half a revolution moves the blob across."""
    gp = tx.GridParameters(geometry="RL", xmin=0.0, xmax=100.0, num_cells=16, lDim=32,
                           BCL={"h": tx.BC.R1T1}, vars={"h": 1, "u": 2, "v": 3})
    omega = 2.0 * np.pi / 100.0
    model = tx.ModelParameters(ts=0.05, integration_time=50.0, output_interval=50.0,
                               equation_set="LinearAdvectionRL",
                               initial_conditions=str(tmp_path / "ics.csv"),
                               output_dir=str(tmp_path / "out"), grid_params=gp,
                               physical_params={"K": 0.0})
    pts = tx.create_grid(gp, F64, device="cpu").gridpoints()
    r, lam = pts[:, 0], pts[:, 1]
    h0 = np.exp(-(((r - 50.0) / 20.0) ** 2)) * np.exp(-((np.cos(lam) - 1.0) ** 2) * 4.0)
    _write_ics(model.initial_conditions, ["r", "l", "h", "u", "v"], pts,
               [h0, np.zeros_like(r), omega * r])
    phys = run(model)
    h_expect = np.exp(-(((r - 50.0) / 20.0) ** 2)) * np.exp(
        -((np.cos(lam - np.pi) - 1.0) ** 2) * 4.0)
    err = np.sqrt(np.mean((phys[0].reshape(-1) - h_expect) ** 2)) / h_expect.max()
    assert err < 0.08, err


def test_rz_translation(tmp_path):
    """test_advection_2d.py:47: uniform (u, w) translates the blob."""
    gp = tx.GridParameters(geometry="RZ", xmin=0.0, xmax=1000.0, num_cells=25, zmin=0.0,
                           zmax=1000.0, zDim=24, vars={"h": 1, "u": 2, "v": 3, "w": 4})
    u0, w0, T = 2.0, 1.0, 30.0
    model = tx.ModelParameters(ts=0.5, integration_time=T, output_interval=T,
                               equation_set="LinearAdvectionRZ",
                               initial_conditions=str(tmp_path / "ics.csv"),
                               output_dir=str(tmp_path / "out"), grid_params=gp,
                               physical_params={"K": 0.0})
    pts = tx.create_grid(gp, F64, device="cpu").gridpoints()
    r, z = pts[:, 0], pts[:, 1]

    def blob(rc, zc):
        return np.exp(-(((r - rc) / 120.0) ** 2) - ((z - zc) / 120.0) ** 2)

    _write_ics(model.initial_conditions, ["r", "z", "h", "u", "v", "w"], pts,
               [blob(400.0, 400.0), np.full_like(r, u0), np.zeros_like(r), np.full_like(r, w0)])
    phys = run(model)
    h_expect = blob(400.0 + u0 * T, 400.0 + w0 * T)
    err = np.sqrt(np.mean((phys[0].reshape(-1) - h_expect) ** 2)) / h_expect.max()
    assert err < 0.08, err


def test_xyz_bubble_runs_with_closure(tmp_path):
    """test_smagorinsky.py:98: the XYZ moist bubble with smagorinsky=0.18
    stays finite, still rises, and the closure does not amplify w beyond
    the constant-K run's by more than 5%."""
    jgp, jgrid = jxyz._xyz_grid()
    grid = tx.create_grid(port_params(jgp), F64, device="cpu")
    pts = grid.gridpoints()
    x = pts[:, 0].reshape(grid.spatial_shape)
    z = pts[:, 2].reshape(grid.spatial_shape)
    phys0 = np.zeros((grid.nvars,) + grid.spatial_shape)
    phys0[0] = jxyz._bubble_s(x, z)
    outs = {}
    for name, extra in (("base", {}), ("smag", {"smagorinsky": 0.18})):
        jm = jxyz._model(tmp_path, jgp, "MoistEulerXYZ", "ics.csv")
        model = port_model(dataclasses.replace(jm, options={**jm.opts(), **extra}))
        ctx = tmodel.build_context(model, grid, F64)
        state = tti.initial_state(grid.analysis(torch.from_numpy(phys0)),
                                  (grid.nvars,) + grid.spatial_shape, F64)
        state = tmodel.make_scan(tmodel.build_step(model, grid, ctx, F64), 300)(state)
        outs[name] = grid.synthesis(state.spec)["val"].numpy()
    for name, phys in outs.items():
        assert np.isfinite(phys).all(), name
    w_b, w_s = outs["base"][5], outs["smag"][5]
    assert w_s.max() > 0.01
    assert w_s.max() <= w_b.max() * 1.05
