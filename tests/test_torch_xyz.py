"""The XYZ Cartesian box of scythe_tpu_torch against scythe_tpu.

Float64 on the CPU, inputs from a seed with numpy.  Tolerances: the grid's
operators, masks, coordinates and grid points within 1e-12 of each array's
max (they come from the same float64 numpy builders); an analysis and
synthesis round trip 1e-12; MoistEulerXYZ's tendencies on random fields
1e-12 and 20 steps 1e-9 of each variable's max|ref| (the tests/test_golden.py
bar), with the example's options and under profile='moist_production' (the
variable-coefficient semi-implicit solve).  Then the gates of
tests/test_xyz.py and tests/test_profile.py::test_profile_runs_shower_xyz,
run on the port with the same bounds, and the convective-shower example's
configuration and ICs against the JAX example's.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scythe_tpu as jx
from scythe_tpu import model as jmodel
from scythe_tpu import timeintegration as jti
from scythe_tpu.physics import turbulence as jtb

import scythe_tpu_torch as tx
from scythe_tpu_torch import convert
from scythe_tpu_torch import model as tmodel
from scythe_tpu_torch import timeintegration as tti
from scythe_tpu_torch.examples import convective_shower_xyz as shower
from scythe_tpu_torch.ops import rlz_analysis
from scythe_tpu_torch.physics import turbulence as ttb

import test_xyz as jxyz
from test_torch_shallow_water import (
    Case, assert_results_close, build_pair, per_var_close, step_pair, tendency_pair,
)

torch.set_num_threads(2)

LX, LY, LZ = jxyz.LX, jxyz.LY, jxyz.LZ
VARS = ("s", "xi", "mu", "u", "v", "w", "mu_c", "mu_r", "qss")
OPERATORS = ("analysis_r", "project_r", "msolve_r", "synth_r", "synth_r_val", "ring_mask",
             "l_analysis", "l_synth", "l_all", "analysis_z", "z_all", "zcol_int",
             "zcol_deriv", "zcol_filter", "zcol_deriv_ftop")


def assert_grids_match(gj, gt):
    """Every operator, mask, coordinate and grid point of the port's grid
    within 1e-12 of the JAX package's (used by the SL and SLZ files too)."""
    assert gt.spatial_shape == gj.spatial_shape
    assert gt.spectral_shape == gj.spectral_shape
    assert gt.field_keys == gj.field_keys and gt._struct == gj._struct
    assert (gt.nl, gt.kDim) == (gj.nl, gj.kDim)
    for k in OPERATORS:
        a, b = getattr(gj, k), getattr(gt, k)
        assert (a is None) == (b is None), k
        if a is not None:
            a = np.asarray(a)
            assert b.shape == a.shape, k
            assert np.abs(b.numpy() - a).max() <= 1e-12 * max(np.abs(a).max(), 1.0), k
    assert np.array_equal(gt.r_mish, gj.r_mish)
    if gj.z_mish is not None:
        assert np.array_equal(gt.z_mish, gj.z_mish)
    assert np.abs(gt.gridpoints() - gj.gridpoints()).max() <= 1e-12 * np.abs(
        gj.gridpoints()).max()
    cj, ct = gj.coords(), gt.coords()
    assert sorted(cj) == sorted(ct)
    for k in cj:
        a = np.asarray(cj[k])
        assert ct[k].shape == a.shape, k
        assert np.abs(ct[k].numpy() - a).max() <= 1e-12 * max(np.abs(a).max(), 1.0), k


def assert_round_trip_matches(gj, gt, seed=0):
    """analysis then synthesis of one random field, every slot, 1e-12."""
    phys = np.random.default_rng(seed).normal(size=(gt.nvars,) + gt.spatial_shape)
    fj = gj.synthesis(gj.analysis(jnp.asarray(phys)))
    ft = gt.synthesis(gt.analysis(torch.from_numpy(phys)))
    assert sorted(ft) == sorted(fj)
    for k in fj:
        per_var_close(ft[k], fj[k], 1e-12, k)


def xyz_params(pkg, cells=8, ny=16, nz=16, vars_map=VARS):
    BC = pkg.BC
    return pkg.GridParameters(
        geometry="XYZ", xmin=0.0, xmax=LX, num_cells=cells, lDim=ny, ymin=0.0, ymax=LY,
        zmin=0.0, zmax=LZ, zDim=nz, BCL={"u": BC.R1T0, "w": BC.R1T1},
        BCR={"u": BC.R1T0}, vars=vars_map,
    )


def bubble_ic(pts, names):
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    return {"s": jxyz._bubble_s(x, z) * (1.0 + 0.3 * np.sin(2.0 * np.pi * y / LY))}


MOIST_SCALES = {"s": 2.0, "xi": 0.01, "mu": 0.1, "u": 5.0, "v": 5.0, "w": 2.0,
                "mu_c": 1.0e-4, "mu_r": 1.0e-4, "qss": 1.0e-4}
XYZ = Case("MoistEulerXYZ", xyz_params, {"K": 20.0, "f": 1.0e-4}, ts=0.2, ic=bubble_ic,
           options={"semiimplicit": True, "sedimentation": "active"}, sounding=True,
           val_scale=MOIST_SCALES, abs_vars=("mu_c", "mu_r"))


# ------------------------------------------------------------------ the grid


@pytest.mark.parametrize("ny,nz", [(16, 16), (8, 12)])
def test_grid_matches_jax(ny, nz):
    gj = jx.create_grid(xyz_params(jx, ny=ny, nz=nz), jnp.float64)
    gt = tx.create_grid(xyz_params(tx, ny=ny, nz=nz), torch.float64, device="cpu")
    assert_grids_match(gj, gt)
    assert sorted(gt.coords()) == ["r", "x", "y", "z"]
    # the uniform 2/3-rule mask: every row alike
    mask = gt.ring_mask.numpy()
    assert np.array_equal(mask, np.broadcast_to(mask[0], mask.shape))
    assert_round_trip_matches(gj, gt)


@pytest.mark.parametrize(
    "kw,exc,match",
    [({"lDim": 15}, ValueError, "even lDim"), ({"lDim": 0}, ValueError, "even lDim"),
     ({"ymax": 0.0}, ValueError, "ymax > ymin"),
     ({"lDim": 4096}, None, None),
     ({"zDim": 3}, ValueError, "zDim")],
    ids=["odd-lDim", "no-lDim", "empty-y", "factored-nl", "short-z"],
)
def test_grid_refuses_what_jax_refuses(kw, exc, match):
    """The port refuses what the JAX package refuses; lDim 4096
    (factored-nl) it no longer refuses: the factored DFT is ported, and auto
    takes it there, as in the JAX package, whose grid it matches."""
    import dataclasses

    gp = dataclasses.replace(xyz_params(tx, vars_map=("a",)), **kw)
    if exc is None:
        gj = jx.create_grid(dataclasses.replace(xyz_params(jx, vars_map=("a",)), **kw),
                            jnp.float64)
        gt = tx.create_grid(gp, torch.float64, device="cpu")
        assert gt.l_fact is not None and gj.l_fact is not None
        assert_grids_match(gj, gt)
        assert_round_trip_matches(gj, gt)
        return
    with pytest.raises(exc, match=match):
        tx.create_grid(gp, torch.float64, device="cpu")
    if exc is ValueError:  # the JAX package refuses it alike
        with pytest.raises(ValueError):
            jx.create_grid(dataclasses.replace(xyz_params(jx, vars_map=("a",)), **kw),
                           jnp.float64)


def test_length_scales_match():
    gj = jx.create_grid(xyz_params(jx), jnp.float64)
    gt = tx.create_grid(xyz_params(tx), torch.float64, device="cpu")
    assert ttb.ring_arc_spacing(gt) == pytest.approx(jtb.ring_arc_spacing(gj), rel=1e-15)
    for a, b in zip(ttb.length_scales(gt), jtb.length_scales(gj)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_analysis_goes_through_the_kernel_wrapper(monkeypatch):
    """Grid.analysis sends the RLZ structural class to ops.rlz_analysis
    (the CUDA kernel on the card, its plain version here)."""
    calls = []
    real = rlz_analysis.rlz_analysis
    monkeypatch.setattr(rlz_analysis, "rlz_analysis",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    gt = tx.create_grid(xyz_params(tx), torch.float64, device="cpu")
    phys = torch.from_numpy(np.random.default_rng(1).normal(size=(9,) + gt.spatial_shape))
    got = gt.analysis(phys)
    assert calls == [phys.shape]
    assert torch.equal(got, gt._analysis_with(gt.analysis_r, "vbr", phys))


# --------------------------------------------------------- the equation set


@pytest.mark.parametrize(
    "options",
    [{}, {"condensation": "diagnostic", "stiff_relaxation": "exp"},
     {"smagorinsky": 0.2, "implicit_vdiff": True}, {"smagorinsky": 0.2},
     {"smagorinsky": 0.2, "smagorinsky_axes": "rl"}, {"si_mode": "variable"}],
    ids=["plain", "diagnostic", "smagorinsky-ivd", "smagorinsky", "smagorinsky-rl",
         "variable-si"],
)
def test_tendencies_match(options, tmp_path):
    case = Case(**{**XYZ.__dict__, "options": {**XYZ.options, **options}})
    rj, rt = tendency_pair(case, tmp_path)
    assert_results_close(rj, rt)
    assert (rt.k_v is None) == (rj.k_v is None)
    if rj.k_v is not None:
        per_var_close(rt.k_v[None], np.asarray(rj.k_v)[None], 1e-12, "k_v")


@pytest.mark.parametrize(
    "options",
    [{}, {"profile": "moist_production"}, {"smagorinsky": 0.2, "implicit_vdiff": True},
     # the options that read coords["r"] (here x) and the reference column
     {"surface_fluxes": {"sst": 300.0}, "sponge_width": 3000.0, "sponge_top_width": 2000.0,
      "radiation_width": 2000.0, "radiation_speed": 30.0}],
    ids=["example", "moist_production", "smagorinsky-ivd", "boundary-options"],
)
def test_twenty_steps_match(options, tmp_path):
    pj, pt, _ = step_pair(XYZ, tmp_path, 20, options)
    per_var_close(pt, pj, 1e-9)
    assert pt[5].max() > 0.0  # the thermal starts to rise


def test_jax_state_continues_in_the_port(tmp_path):
    """An XYZ state made by the JAX package moves across at 1e-12 (bitwise
    here) and both go on for ten steps at 1e-9."""
    (mj, gj, cj), (mt, gt, ct) = build_pair(XYZ, tmp_path, 1)
    phys0 = np.zeros((9,) + gt.spatial_shape)
    phys0[0] = bubble_ic(gt.gridpoints(), VARS)["s"].reshape(gt.spatial_shape)
    step_j = jax.jit(jmodel.build_step(mj, gj, cj, jnp.float64))
    sj = jti.initial_state(gj.analysis(jnp.asarray(phys0)), (9,) + gt.spatial_shape,
                           jnp.float64, imp_rows=2)
    for _ in range(4):
        sj = step_j(sj)
    st = convert.state_from_numpy(sj, "cpu")
    for k in ("spec", "expdot_nm1", "expdot_nm2", "impdot_nm1", "impdot_nm2"):
        assert np.array_equal(getattr(st, k).numpy(), np.asarray(getattr(sj, k))), k
    step_t = tmodel.build_step(mt, gt, ct, torch.float64)
    for _ in range(10):
        sj, st = step_j(sj), step_t(st)
    assert st.t == int(sj.t) == 15
    per_var_close(gt.synthesis(st.spec)["val"], gj.synthesis(sj.spec)["val"], 1e-9)


# ------------------------------------------- the gates of tests/test_xyz.py


def _port_grid(ny=16, vars_map=None):
    gp = xyz_params(tx, cells=12, ny=ny, nz=16, vars_map=vars_map or VARS)
    return gp, tx.create_grid(gp, torch.float64, device="cpu")


def _port_model(tmp_path, gp, eqset):
    return tx.ModelParameters(
        ts=0.2, integration_time=12.0, output_interval=12.0, equation_set=eqset,
        initial_conditions=str(tmp_path / "unused.csv"), output_dir=str(tmp_path / "out"),
        ref_state_file=jxyz._sounding(tmp_path), grid_params=gp,
        physical_params={"K": 20.0}, options={"semiimplicit": True},
    )


def _port_run(model, grid, phys0, n_steps):
    ctx = tmodel.build_context(model, grid, torch.float64)
    spec0 = grid.analysis(torch.from_numpy(phys0))
    state = tti.initial_state(spec0, (grid.nvars,) + grid.spatial_shape, torch.float64)
    state = tmodel.make_scan(tmodel.build_step(model, grid, ctx, torch.float64), n_steps)(state)
    return grid.synthesis(state.spec)["val"].numpy()


def test_xyz_roundtrip_and_y_derivatives():
    _, grid = _port_grid(vars_map={"a": 1})
    pts = grid.gridpoints()
    x, y, z = (pts[:, i].reshape(grid.spatial_shape) for i in range(3))
    ky = 2
    f = np.sin(2.0 * np.pi * ky * y / LY) * (1.0 + 0.3 * np.cos(2.0 * np.pi * x / LX)) * (z / LZ)
    out = grid.synthesis(grid.analysis(torch.from_numpy(f[None])))
    fit, dy, dyy = (out[k][0].numpy() for k in ("val", "dl", "dll"))
    assert np.abs(fit - f).max() < 2e-3 * np.abs(f).max()
    k = 2.0 * np.pi * ky / LY
    F, D, D2 = (np.fft.rfft(a, axis=1) for a in (fit, dy, dyy))
    assert np.abs(D[:, ky, :] - 1j * k * F[:, ky, :]).max() < 1e-10 * np.abs(F[:, ky, :]).max()
    assert (np.abs(D2[:, ky, :] + k * k * F[:, ky, :]).max()
            < 1e-10 * k * np.abs(F[:, ky, :]).max())
    mask = np.ones(F.shape[1], bool)
    mask[ky] = False
    assert np.abs(D[:, mask, :]).max() < 1e-9 * np.abs(D).max()


def test_xyz_reduces_to_rz_slab(tmp_path):
    """y-invariant XYZ (v = 0, f = 0) is the RZ rainfall_test slab."""
    gp_xyz, grid_xyz = _port_grid()
    gp_rz = tx.GridParameters(
        geometry="RZ", xmin=0.0, xmax=LX, num_cells=12, zmin=0.0, zmax=LZ, zDim=16,
        BCL={"u": tx.BC.R1T0, "w": tx.BC.R1T1}, BCR={"u": tx.BC.R1T0}, vars=jxyz.RZ_VARS,
    )
    grid_rz = tx.create_grid(gp_rz, torch.float64, device="cpu")
    pts = grid_rz.gridpoints()
    s2 = jxyz._bubble_s(pts[:, 0], pts[:, 1]).reshape(grid_rz.spatial_shape)
    phys_rz = np.zeros((gp_rz.nvars,) + grid_rz.spatial_shape)
    phys_rz[0] = s2
    phys_xyz = np.zeros((gp_xyz.nvars,) + grid_xyz.spatial_shape)
    for name in jxyz.RZ_VARS:
        phys_xyz[gp_xyz.var_index(name)] = phys_rz[gp_rz.var_index(name)][:, None, :]
    m_rz = _port_model(tmp_path, gp_rz, "rainfall_test")
    m_rz = m_rz.with_(options={**m_rz.opts(), "exact_vertical_pgf": True})
    out_rz = _port_run(m_rz, grid_rz, phys_rz, 60)
    out_xyz = _port_run(_port_model(tmp_path, gp_xyz, "MoistEulerXYZ"), grid_xyz, phys_xyz, 60)
    assert np.isfinite(out_xyz).all()
    assert np.abs(out_xyz[gp_xyz.var_index("v")]).max() < 1e-8
    for name in jxyz.RZ_VARS:
        a = out_xyz[gp_xyz.var_index(name)]
        b = out_rz[gp_rz.var_index(name)]
        scale = np.abs(b).max() + 1e-12
        err = np.abs(a - b[:, None, :]).max()
        assert err < 1e-8 * max(scale, 1.0), (name, err, scale)


def test_xyz_y_translation_equivariance(tmp_path):
    gp, grid = _port_grid()
    phys0 = np.zeros((gp.nvars,) + grid.spatial_shape)
    phys0[0] = bubble_ic(grid.gridpoints(), VARS)["s"].reshape(grid.spatial_shape)
    model = _port_model(tmp_path, gp, "MoistEulerXYZ")
    out = _port_run(model, grid, phys0, 30)
    out_rolled = _port_run(model, grid, np.roll(phys0, 5, axis=2), 30)
    assert np.abs(np.roll(out, 5, axis=2) - out_rolled).max() < 1e-9 * np.abs(out).max()


def test_profile_runs_shower_xyz(tmp_path):
    """tests/test_profile.py's gate: moist_production integrates the XYZ
    bubble 150 steps to a finite, rising state."""
    gp, grid = _port_grid()
    pts = grid.gridpoints()
    phys0 = np.zeros((grid.nvars,) + grid.spatial_shape)
    phys0[0] = jxyz._bubble_s(pts[:, 0], pts[:, 2]).reshape(grid.spatial_shape)
    model = _port_model(tmp_path, gp, "MoistEulerXYZ").with_(
        options={"profile": "moist_production"})
    phys = _port_run(model, grid, phys0, 150)
    assert np.isfinite(phys).all()
    assert phys[5].max() > 0.01


# ------------------------------------------------- the convective shower


_spec = importlib.util.spec_from_file_location(
    "shower_example_jax",
    os.path.join(os.path.dirname(__file__), "..", "examples", "convective_shower_xyz.py"),
)
jshower = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jshower)


def test_shower_configuration_and_ics_are_the_jax_example(tmp_path):
    kw = dict(num_cells=8, ny=8, nz=12, t_end=60.0)
    mj = jshower.build_model(str(tmp_path / "jax"), **kw)
    mt = shower.shower_model(str(tmp_path / "torch"), **kw)
    for k in ("ts", "integration_time", "output_interval", "equation_set"):
        assert getattr(mt, k) == getattr(mj, k)
    assert mt.phys() == mj.phys() and mt.opts() == mj.opts()
    for k in ("geometry", "xmin", "xmax", "num_cells", "lDim", "ymin", "ymax", "zmin",
              "zmax", "zDim", "vars"):
        assert getattr(mt.grid_params, k) == getattr(mj.grid_params, k), k
    for k in ("BCL", "BCR", "BCB", "BCT"):
        assert ([b.name for b in getattr(mt.grid_params, k)]
                == [b.name for b in getattr(mj.grid_params, k)]), k
    assert open(mt.ref_state_file).read() == open(mj.ref_state_file).read()
    gj = jx.create_grid(mj.grid_params, jnp.float64)
    jshower.write_ics(mj, gj, jmodel.build_context(mj, gj, jnp.float64).ref_state)
    a = np.loadtxt(mj.initial_conditions, delimiter=",", skiprows=1)
    b = np.loadtxt(mt.initial_conditions, delimiter=",", skiprows=1)
    with open(mt.initial_conditions) as f:
        assert f.readline().strip() == "x,y,z," + ",".join(VARS)
    per_var_close(b.T, a.T, 1e-12)
    # the full-width defaults of the example
    full = shower.build_model(str(tmp_path / "full"))
    gp = full.grid_params
    assert (gp.num_cells, gp.rDim, gp.lDim, gp.zDim, full.ts) == (48, 144, 16, 32, 0.25)


def test_shower_readings_through_integrate_model(tmp_path):
    """The example's entry, reduced in size and time, through
    integrate_model in both packages: the same final fields at 1e-9."""
    kw = dict(num_cells=8, ny=8, nz=12, t_end=2.5)
    mj = jshower.build_model(str(tmp_path / "jax"), **kw)
    mt = shower.shower_model(str(tmp_path / "torch"), **kw)
    gj = jx.create_grid(mj.grid_params, jnp.float64)
    jshower.write_ics(mj, gj, jmodel.build_context(mj, gj, jnp.float64).ref_state)
    _, pj = jx.integrate_model(mj, dtype=jnp.float64, write_outputs=False)
    _, pt = tx.integrate_model(mt, dtype=torch.float64, write_outputs=False, device="cpu")
    per_var_close(pt, pj, 1e-9)
    r = shower.readings(pt)
    assert r["w_max"] > 0.0 and r["qr_max"] >= 0.0
