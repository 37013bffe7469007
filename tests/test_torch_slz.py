"""The SLZ spherical shell and MoistEulerSLZ of scythe_tpu_torch against
scythe_tpu.

Float64 on the CPU, inputs from a seed with numpy.  Tolerances: the grid's
operators, masks, coordinates and grid points within 1e-12; an analysis and
synthesis round trip 1e-12; MoistEulerSLZ's tendencies on random fields
(with Smagorinsky, implicit vertical diffusion, hyperdiffusion) 1e-12 and 20
steps 1e-9 of each variable's max|ref|.  Then the gates of tests/test_slz.py
on the port with the same bounds.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scythe_tpu as jx
from scythe_tpu import model as jmodel
from scythe_tpu.equations.common import get_equation_set as jget
from scythe_tpu.physics import turbulence as jtb

import scythe_tpu_torch as tx
from scythe_tpu_torch import convert
from scythe_tpu_torch import io as tio
from scythe_tpu_torch import model as tmodel
from scythe_tpu_torch import timeintegration as tti
from scythe_tpu_torch.equations.common import get_equation_set as tget
from scythe_tpu_torch.ops import rlz_analysis
from scythe_tpu_torch.physics import thermodynamics as td
from scythe_tpu_torch.physics import turbulence as ttb

import test_slz as jslz
from test_torch_shallow_water import (
    Case, assert_results_close, build_pair, per_var_close, step_pair, tendency_pair,
)
from test_torch_xyz import MOIST_SCALES, assert_grids_match, assert_round_trip_matches

torch.set_num_threads(2)

VARS = tuple(jslz.VARS)


def slz_params(pkg, cells=8, nl=16, nz=16, zmax=15000.0, vars_map=VARS):
    ZBC = pkg.ZBC
    return pkg.GridParameters(
        geometry="SLZ", xmin=-np.pi / 2, xmax=np.pi / 2, num_cells=cells, lDim=nl,
        sphere_radius=6.37122e6, zmin=0.0, zmax=zmax, zDim=nz,
        BCB={"s": ZBC.R1T1, "u": ZBC.R1T1, "v": ZBC.R1T1, "mu": ZBC.R1T1,
             "mu_c": ZBC.R1T1, "w": ZBC.R1T0},
        BCT={"s": ZBC.R1T1, "u": ZBC.R1T1, "v": ZBC.R1T1, "mu": ZBC.R1T1,
             "mu_c": ZBC.R1T1, "mu_r": ZBC.R1T1, "w": ZBC.R1T0},
        vars=vars_map,
    )


def thermal_ic(pts, names):
    phi, lam, z = pts[:, 0], pts[:, 1], pts[:, 2]
    rad = np.sqrt(((phi - np.pi / 6) / 0.5) ** 2 + ((lam - np.pi) / 0.5) ** 2
                  + ((z - 1500.0) / 1500.0) ** 2)
    return {"s": 10.0 * np.maximum(0.0, np.cos(np.pi * np.minimum(rad, 1.0) / 2.0)) ** 2}


SLZ = Case("MoistEulerSLZ", slz_params, {"K": 100.0}, ts=0.25, ic=thermal_ic,
           options={"semiimplicit": True, "sedimentation": "active"}, sounding=True,
           val_scale=MOIST_SCALES, abs_vars=("mu_c", "mu_r"))


@pytest.mark.parametrize("cells,nl,nz", [(8, 16, 16), (12, 32, 24)])
def test_grid_matches_jax(cells, nl, nz):
    gj = jx.create_grid(slz_params(jx, cells, nl, nz), jnp.float64)
    gt = tx.create_grid(slz_params(tx, cells, nl, nz), torch.float64, device="cpu")
    assert_grids_match(gj, gt)
    assert sorted(gt.coords()) == ["l", "lat", "lon", "r", "z"]
    assert_round_trip_matches(gj, gt)


def test_length_scales_match():
    gj = jx.create_grid(slz_params(jx), jnp.float64)
    gt = tx.create_grid(slz_params(tx), torch.float64, device="cpu")
    for a, b in zip(ttb.length_scales(gt), jtb.length_scales(gj)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_analysis_goes_through_the_kernel_wrapper(monkeypatch):
    calls = []
    real = rlz_analysis.rlz_analysis
    monkeypatch.setattr(rlz_analysis, "rlz_analysis",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    gt = tx.create_grid(slz_params(tx), torch.float64, device="cpu")
    phys = torch.from_numpy(np.random.default_rng(2).normal(size=(9,) + gt.spatial_shape))
    gt.analysis(phys)
    assert calls == [phys.shape]


@pytest.mark.parametrize(
    "options",
    [{}, {"condensation": "diagnostic", "stiff_relaxation": "exp"},
     {"smagorinsky": 0.2, "implicit_vdiff": True},
     {"smagorinsky": 0.2, "smagorinsky_axes": "rl"}, {"hyperdiffusion_k4": 1.0e12},
     {"si_mode": "variable", "reference_quirks": True}],
    ids=["plain", "diagnostic", "smagorinsky-ivd", "smagorinsky-rl", "hyperdiffusion",
         "variable-si-quirks"],
)
def test_tendencies_match(options, tmp_path):
    case = Case(**{**SLZ.__dict__, "options": {**SLZ.options, **options}})
    rj, rt = tendency_pair(case, tmp_path)
    assert_results_close(rj, rt)
    if rj.k_v is not None:
        per_var_close(rt.k_v[None], np.asarray(rj.k_v)[None], 1e-12, "k_v")


def test_hyperdiffusion_guard_refuses_what_jax_refuses(tmp_path):
    """The del^4 explicit-stability guard, in both packages alike."""
    case = Case(**{**SLZ.__dict__, "options": {**SLZ.options, "hyperdiffusion_k4": 1.0e24}})
    (_, gj, cj), (_, gt, ct) = build_pair(case, tmp_path)
    fields = {k: np.zeros((9,) + gt.spatial_shape) for k in gt.field_keys}
    with pytest.raises(ValueError, match="CFL"):
        jget("MoistEulerSLZ")({k: jnp.asarray(a) for k, a in fields.items()}, cj)
    with pytest.raises(ValueError, match="CFL"):
        tget("MoistEulerSLZ")({k: torch.from_numpy(a) for k, a in fields.items()}, ct)


@pytest.mark.parametrize(
    "options", [{}, {"profile": "moist_production"}], ids=["example", "moist_production"])
def test_twenty_steps_match(options, tmp_path):
    pj, pt, _ = step_pair(SLZ, tmp_path, 20, options)
    per_var_close(pt, pj, 1e-9)


def test_jax_state_continues_in_the_port(tmp_path):
    """A JAX SLZ state moves across bitwise; both go on 10 steps at 1e-9."""
    import jax

    from scythe_tpu import timeintegration as jti

    (mj, gj, cj), (mt, gt, ct) = build_pair(SLZ, tmp_path, 1)
    phys0 = np.zeros((9,) + gt.spatial_shape)
    phys0[0] = thermal_ic(gt.gridpoints(), VARS)["s"].reshape(gt.spatial_shape)
    step_j = jax.jit(jmodel.build_step(mj, gj, cj, jnp.float64))
    sj = jti.initial_state(gj.analysis(jnp.asarray(phys0)), (9,) + gt.spatial_shape,
                           jnp.float64, imp_rows=2)
    for _ in range(3):
        sj = step_j(sj)
    st = convert.state_from_numpy(sj, "cpu")
    for k in ("spec", "expdot_nm1", "impdot_nm2"):
        assert np.array_equal(getattr(st, k).numpy(), np.asarray(getattr(sj, k))), k
    step_t = tmodel.build_step(mt, gt, ct, torch.float64)
    for _ in range(10):
        sj, st = step_j(sj), step_t(st)
    per_var_close(gt.synthesis(st.spec)["val"], gj.synthesis(sj.spec)["val"], 1e-9)


# ------------------------------------------ the gates of tests/test_slz.py


def _port(model):
    grid = tx.create_grid(model.grid_params, torch.float64, device="cpu")
    return grid, tmodel.build_context(model, grid, torch.float64)


def _model(tmp_path, **kw):
    """tests/test_slz.py's configuration (12 cells x 32 x 24), the port's."""
    m = jslz._model(tmp_path, **kw)
    return tx.ModelParameters(
        ts=m.ts, integration_time=m.integration_time, output_interval=m.output_interval,
        equation_set=m.equation_set, initial_conditions=m.initial_conditions,
        output_dir=m.output_dir, ref_state_file=m.ref_state_file,
        grid_params=slz_params(tx, 12, 32, 24, zmax=m.grid_params.zmax),
        physical_params=m.phys(), options=m.opts(),
    )


def _run_from(model, grid, ctx, phys0, n):
    spec0 = grid.analysis(torch.from_numpy(phys0))
    state = tti.initial_state(spec0, (grid.nvars,) + grid.spatial_shape, torch.float64)
    state = tmodel.make_scan(tmodel.build_step(model, grid, ctx, torch.float64), n)(state)
    return grid.synthesis(state.spec)["val"].numpy()


def test_slz_model_is_the_jax_tests(tmp_path):
    mj, mt = jslz._model(tmp_path), _model(tmp_path)
    for k in ("ts", "integration_time", "equation_set"):
        assert getattr(mt, k) == getattr(mj, k)
    assert mt.phys() == mj.phys() and mt.opts() == mj.opts()
    for k in ("geometry", "xmin", "xmax", "num_cells", "lDim", "sphere_radius", "zmax",
              "zDim", "vars"):
        assert getattr(mt.grid_params, k) == getattr(mj.grid_params, k), k
    for k in ("BCB", "BCT"):
        assert ([b.name for b in getattr(mt.grid_params, k)]
                == [b.name for b in getattr(mj.grid_params, k)])


def test_slz_global_balance(tmp_path):
    """Zero perturbation on the balanced reference state stays below 1e-10
    pole to pole over 600 steps."""
    model = _model(tmp_path)
    grid, ctx = _port(model)
    phys = _run_from(model, grid, ctx, np.zeros((grid.nvars,) + grid.spatial_shape), 600)
    assert np.isfinite(phys).all()
    assert np.abs(phys[5]).max() < 1e-10
    assert np.abs(phys[3]).max() < 1e-10


def test_slz_deep_shell_with_stiff_relaxation(tmp_path):
    m0 = _model(tmp_path, ts=1.0)
    model = m0.with_(grid_params=dataclasses.replace(m0.grid_params, zmax=20000.0),
                     options={**m0.opts(), "stiff_relaxation": "exp"})
    grid, ctx = _port(model)
    phys = _run_from(model, grid, ctx, np.zeros((grid.nvars,) + grid.spatial_shape), 120)
    assert np.isfinite(phys).all()
    assert np.abs(phys[5]).max() < 1e-10


def test_slz_midlatitude_bubble_rises(tmp_path):
    model = _model(tmp_path)
    grid, ctx = _port(model)
    pts = grid.gridpoints()
    phi, lam, z = (pts[:, i].reshape(grid.spatial_shape) for i in range(3))
    rad = np.sqrt(((phi - np.pi / 6) / 0.5) ** 2 + ((lam - np.pi) / 0.5) ** 2
                  + ((z - 1500.0) / 1500.0) ** 2)
    shape = np.maximum(0.0, np.cos(np.pi * np.minimum(rad, 1.0) / 2.0)) ** 2
    phys0 = np.zeros((grid.nvars,) + grid.spatial_shape)
    phys0[0] = 10.0 * shape
    mubar = ctx.ref_state.mubar[:, 0].numpy()[None, None, :]
    qv_bar = td.ahyp(torch.from_numpy(mubar)).numpy() * np.ones_like(z)
    phys0[2] = td.bhyp(torch.from_numpy(qv_bar * (1.0 + 0.3 * shape))).numpy() - mubar
    phys = _run_from(model, grid, ctx, phys0, 1400)
    assert np.isfinite(phys).all()
    w = phys[VARS.index("w")]
    assert np.abs(w).max() < 1.5, np.abs(w).max()
    band = np.abs(np.degrees(grid.r_mish) - 30.0) < 20.0
    wb = w[band]
    ib = np.unravel_index(np.argmax(wb), wb.shape)
    assert wb.max() > 0.01, wb.max()
    assert grid.z_mish[ib[2]] > 500.0, grid.z_mish[ib[2]]


def test_slz_csv_driver_roundtrip(tmp_path):
    model = _model(tmp_path, T=5.0).with_(
        initial_conditions=str(tmp_path / "ics.csv"), output_dir=str(tmp_path / "out"))
    grid, _ = _port(model)
    pts = grid.gridpoints()
    cols = np.zeros((len(pts), 3 + len(VARS)))
    cols[:, :3] = pts
    cols[:, 3] = 0.5 * np.exp(-(((pts[:, 2] - 3000.0) / 2000.0) ** 2))
    tio._write_csv(model.initial_conditions, ["lat", "lon", "z", *VARS], cols)
    grid2, phys = tx.integrate_model(model, dtype=torch.float64, device="cpu")
    assert np.isfinite(phys).all()
    outs = sorted(os.listdir(model.output_dir))
    assert any(f.startswith("physical_out_5.0") for f in outs), outs
    back = tio.read_physical_grid(os.path.join(model.output_dir, "physical_out_5.0.csv"),
                                  grid2)
    assert np.abs(back - phys).max() < 1e-12
    with open(os.path.join(model.output_dir, "physical_out_5.0.csv")) as f:
        assert f.readline().strip() == "lat,lon,z," + ",".join(VARS)
