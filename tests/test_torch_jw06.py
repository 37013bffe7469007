"""tests/test_jw06.py's gates on the port: the Jablonowski & Williamson
(2006) baroclinic wave on the SLZ shell (scythe_tpu_torch.examples.
jw06_baroclinic_slz), float64 on the CPU at the JAX tests' sizes and
bounds: the fitted state's discrete balance, a steady window, the l_q 0
analysis as a left inverse, a day of wave growth on the balanced base, and
the production stabilizer bundle.
"""

import numpy as np
import torch

import scythe_tpu_torch as tx
from scythe_tpu_torch import model as tmodel
from scythe_tpu_torch import timeintegration as tti
from scythe_tpu_torch.balance import balance_zonal_state
from scythe_tpu_torch.examples import jw06_baroclinic_slz as tw
from scythe_tpu_torch.physics import thermodynamics as td

torch.set_num_threads(2)
F64 = torch.float64


def _setup(tmp_path, cells=12, nl=32, zdim=20, ts=15.0, **kw):
    model = tw.build_model(str(tmp_path), num_cells=cells, nl=nl, zdim=zdim, ts=ts,
                           t_end=86400.0, **kw)
    grid = tx.create_grid(model.grid_params, F64, device="cpu")
    return model, grid, tmodel.build_context(model, grid, F64)


def _run(model, grid, ctx, phys0, n, imp_rows=None, boundary_refs=False):
    spec0 = grid.analysis(torch.from_numpy(np.asarray(phys0)))
    if boundary_refs:
        tmodel._set_boundary_refs(ctx, grid, spec0)
    state = tti.initial_state(spec0, (grid.nvars,) + grid.spatial_shape, F64,
                              imp_rows=imp_rows)
    step = tmodel.build_step(model, grid, ctx, F64)
    state = tmodel.make_scan(step, n)(state)
    return grid.synthesis(state.spec)["val"].numpy()


def test_initial_state_discretely_balanced(tmp_path):
    """test_jw06.py:48: the fitted analytic state's w forcing < 0.25 m/s^2,
    and the uncorrected pgf form 4x worse."""
    model, grid, ctx = _setup(tmp_path)
    phys0 = tw.initial_fields(grid, ctx.ref_state, perturb=False)
    f = grid.synthesis(grid.analysis(torch.from_numpy(phys0)))
    val, dz = f["val"], f["dz"]
    rs = ctx.ref_state
    sbar, xibar, mubar = (a[None, None, :, 0] for a in (rs.sbar, rs.xibar, rs.mubar))
    q_v, rho_d, Tk, _ = td.thermodynamic_tuple(val[0] + sbar, val[1] + xibar, val[2] + mubar)
    rho_t = rho_d * (1.0 + q_v)
    rhobar = td.dry_density(xibar) * (1.0 + td.ahyp(mubar))
    coeffs = td.pressure_gradient_coeffs(Tk, rho_d, q_v)
    mu_fac = td.dmudq(val[2] + mubar, q_v)
    dpdz = ctx.vertical_pgf(coeffs, dz[0], dz[1], dz[2] / mu_fac)
    force = ((-td.GRAVITY * (rho_t - rhobar) - dpdz) / rho_t).numpy()
    assert np.isfinite(force).all()
    assert np.abs(force).max() < 0.25, np.abs(force).max()
    base = ctx.vertical_pgf(coeffs, dz[0], dz[1], dz[2] / mu_fac, default_exact=False)
    force_unc = ((-td.GRAVITY * (rho_t - rhobar) - base) / rho_t).numpy()
    assert np.abs(force_unc).max() > 4.0 * np.abs(force).max()


def test_steady_state_short_window(tmp_path):
    """test_jw06.py:91: 100 steps of the unperturbed state, finite, w
    bounded, the jet intact."""
    model, grid, ctx = _setup(tmp_path)
    phys0 = tw.initial_fields(grid, ctx.ref_state, perturb=False)
    phys = _run(model, grid, ctx, phys0, 100)
    assert np.isfinite(phys).all()
    assert np.abs(phys[5]).max() < 1.0, np.abs(phys[5]).max()
    assert abs(phys[3].max() - phys0[3].max()) < 0.15 * phys0[3].max()


def test_lq0_analysis_is_idempotent(tmp_path):
    """test_jw06.py:109: with l_q 0 the analysis is a left inverse of the
    synthesis (50 round trips bitwise-neutral to 1e-10); the default l_q 2
    penalty erodes the jet measurably."""
    model, grid, ctx = _setup(tmp_path, cells=8, nl=24, zdim=12, l_q=0.0)
    phys0 = tw.initial_fields(grid, ctx.ref_state, perturb=False)
    spec = s = grid.analysis(torch.from_numpy(phys0))
    for _ in range(50):
        s = grid.analysis(grid.synthesis(s)["val"])
    assert float((s - spec).abs().max()) < 1e-10 * float(spec.abs().max())
    model2, grid2, _ = _setup(tmp_path / "lq2", cells=8, nl=24, zdim=12, l_q=2.0)
    s2 = spec2 = grid2.analysis(torch.from_numpy(phys0))
    for _ in range(50):
        s2 = grid2.analysis(grid2.synthesis(s2)["val"])
    u0 = float(grid2.synthesis(spec2)["val"][3].max())
    assert float(grid2.synthesis(s2)["val"][3].max()) < u0 - 0.05


def test_wave_growth_on_balanced_base(tmp_path):
    """test_jw06.py:180: one simulated day (5760 steps) of the perturbed
    state on the l_q 0, balanced base with the horizontal Smagorinsky
    closure: the jet holds (loss under 1.5 m/s) and the eddy grows into
    0.05 < |v|_max < 0.5 m/s."""
    model, grid, ctx = _setup(tmp_path, cells=8, nl=16, zdim=16, l_q=0.0, smag=0.21)
    base0 = tw.initial_fields(grid, ctx.ref_state, perturb=False)
    zm = base0.mean(axis=2)
    bal, info = balance_zonal_state(model, zm, device="cpu")
    assert info["history"][-1] < 1e-3 * info["history"][0]
    phys0 = tw.initial_fields(grid, ctx.ref_state, perturb=True) + (bal - zm)[:, :, None, :]
    phys = _run(model, grid, ctx, phys0, 5760, imp_rows=2)
    assert np.isfinite(phys).all()
    u0, u1 = float(phys0[3].max()), float(phys[3].max())
    v1 = float(np.abs(phys[4]).max())
    assert u1 > u0 - 1.5, (u0, u1)
    assert 0.05 < v1 < 0.5, v1


def test_production_bundle_short_window(tmp_path):
    """test_jw06.py:228: the round-5 stabilizer bundle (12 km top sponge,
    del^4, incremental analysis, isotropic Smagorinsky with implicit
    vertical diffusion) builds and runs 100 steps finite, w bounded, the jet
    intact."""
    model, grid, ctx = _setup(tmp_path, cells=12, nl=24, zdim=12, l_q=0.0, k4=5.0e15,
                              smag=0.21, ivd=True, sponge_top=12.0e3)
    for key in ("hyperdiffusion_k4", "smagorinsky", "implicit_vdiff",
                "incremental_analysis", "sponge_top_width"):
        assert key in model.opts(), key
    phys0 = tw.initial_fields(grid, ctx.ref_state, perturb=True)
    phys = _run(model, grid, ctx, phys0, 100, imp_rows=2, boundary_refs=True)
    assert np.isfinite(phys).all()
    assert np.abs(phys[5]).max() < 1.0, np.abs(phys[5]).max()
    assert phys[3].max() > 30.0


def test_production_model_is_the_recipe(tmp_path):
    """production_model: the JAX example's production command line (48
    cells x 96 x 24, ts 7.5, l_q 0, 12 km sponge, K4 6e16, Smagorinsky 0.21
    on the horizontal, incremental analysis)."""
    m = tw.production_model(str(tmp_path))
    gp = m.grid_params
    assert (gp.num_cells, gp.lDim, gp.zDim, gp.l_q, m.ts) == (48, 96, 24, 0.0, 7.5)
    assert gp.rDim == 144
    o = m.opts()
    assert (o["sponge_top_width"], o["hyperdiffusion_k4"], o["smagorinsky"],
            o["smagorinsky_axes"], o["incremental_analysis"]) == (12.0e3, 6.0e16, 0.21, "rl",
                                                                  True)
