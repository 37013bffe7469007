"""The SL spherical shell of scythe_tpu_torch against scythe_tpu.

Float64 on the CPU, inputs from a seed with numpy.  Tolerances: the grid's
operators, masks, coordinates and grid points within 1e-12; an analysis and
synthesis round trip 1e-12; ShallowWaterSphere (with and without
topography) and AdvectionSphere tendencies on random fields 1e-12 and 20
steps 1e-9 of each variable's max|ref|; the topography extras built by each
package, and carried across by convert, 1e-12.  Then the gates of
tests/test_sphere.py (Williamson cases 1, 2, 5 and 6, the pole-ring mask,
the topography_file driver path) on the port with the same bounds, and the
configuration of models/williamson2_sphere.py.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scythe_tpu as jx
from scythe_tpu import model as jmodel
from scythe_tpu.basis import bspline as jbspline
from scythe_tpu.equations.common import get_equation_set as jget
from scythe_tpu.physics import turbulence as jtb

import scythe_tpu_torch as tx
from scythe_tpu_torch import convert
from scythe_tpu_torch import model as tmodel
from scythe_tpu_torch.equations.common import get_equation_set as tget
from scythe_tpu_torch.examples import williamson_sphere as wm
from scythe_tpu_torch.ops import rlz_analysis
from scythe_tpu_torch.physics import turbulence as ttb

import test_sphere as jsphere
from test_torch_shallow_water import (
    Case, assert_results_close, build_pair, per_var_close, step_pair, tendency_pair,
)
from test_torch_xyz import assert_grids_match, assert_round_trip_matches

torch.set_num_threads(2)

jwm = jsphere.wm  # the JAX example module


def sl_params(pkg, cells=12, nl=24, vars_map=("h", "u", "v")):
    return pkg.GridParameters(
        geometry="SL", xmin=-np.pi / 2, xmax=np.pi / 2, num_cells=cells, lDim=nl,
        sphere_radius=wm.A_EARTH, vars=vars_map,
    )


def w6_ic(pts, names):
    h, u, v = wm.w6_fields(pts[:, 0], pts[:, 1])
    return {"h": h, "u": u, "v": v}


def w5_ic(pts, names):
    h, u, v, _ = wm.w5_fields(pts[:, 0], pts[:, 1])
    return {"h": h, "u": u, "v": v}


def bell_ic(pts, names):
    return {"h": wm.w1_bell(pts[:, 0], pts[:, 1])}


SW = Case("ShallowWaterSphere", sl_params, {"g": wm.G, "Omega": wm.OMEGA, "K": 0.0},
          ts=300.0, ic=w6_ic, val_scale={"h": 8000.0, "u": 50.0, "v": 20.0},
          deriv_scale=1.0e-1)
SW_K = Case(**{**SW.__dict__, "params": {**SW.params, "K": 1.0e5}})
ADV = Case("AdvectionSphere", lambda pkg: sl_params(pkg, vars_map=("h",)),
           {"u0": 2 * np.pi * wm.A_EARTH / (12 * 86400.0), "alpha": np.pi / 2}, ts=300.0,
           ic=bell_ic, val_scale=500.0)


# ------------------------------------------------------------------ the grid


@pytest.mark.parametrize("cells,nl", [(12, 24), (32, 96)])
def test_grid_matches_jax(cells, nl):
    gj = jx.create_grid(sl_params(jx, cells, nl), jnp.float64)
    gt = tx.create_grid(sl_params(tx, cells, nl), torch.float64, device="cpu")
    assert_grids_match(gj, gt)
    assert sorted(gt.coords()) == ["l", "lat", "lon", "r"]
    assert_round_trip_matches(gj, gt)


@pytest.mark.parametrize(
    "kw,exc,match",
    [({"lDim": 23}, ValueError, "even lDim"),
     ({"xmin": -90.0, "xmax": 90.0}, ValueError, "RADIANS"),
     ({"xmin": 0.5, "xmax": 0.2}, ValueError, "RADIANS"),
     ({"lDim": 4096}, None, None)],
    ids=["odd-lDim", "degrees", "empty", "factored-nl"],
)
def test_grid_refuses_what_jax_refuses(kw, exc, match):
    """The port refuses what the JAX package refuses; lDim 4096
    (factored-nl) it no longer refuses: the factored DFT is ported, and auto
    takes it there, as in the JAX package, whose grid it matches."""
    import dataclasses

    if exc is None:
        gj = jx.create_grid(dataclasses.replace(sl_params(jx), **kw), jnp.float64)
        gt = tx.create_grid(dataclasses.replace(sl_params(tx), **kw), torch.float64,
                            device="cpu")
        assert gt.l_fact is not None and gj.l_fact is not None
        assert_grids_match(gj, gt)
        assert_round_trip_matches(gj, gt)
        return
    with pytest.raises(exc, match=match):
        tx.create_grid(dataclasses.replace(sl_params(tx), **kw), torch.float64, device="cpu")
    if exc is ValueError:
        with pytest.raises(ValueError, match=match):
            jx.create_grid(dataclasses.replace(sl_params(jx), **kw), jnp.float64)


def test_length_scales_match():
    gj = jx.create_grid(sl_params(jx), jnp.float64)
    gt = tx.create_grid(sl_params(tx), torch.float64, device="cpu")
    assert np.array_equal(ttb.ring_arc_spacing(gt), np.asarray(jtb.ring_arc_spacing(gj)))
    for a, b in zip(ttb.length_scales(gt), jtb.length_scales(gj)):
        assert (a is None) == (b is None) and np.array_equal(np.asarray(a), np.asarray(b))


def test_sl_analysis_keeps_the_einsum_path(monkeypatch):
    """SL is of the RL structural class: its analysis is the einsum chain,
    and no kernel wrapper is called (the card's SL path launches none)."""
    monkeypatch.setattr(rlz_analysis, "rlz_analysis", None)
    gt = tx.create_grid(sl_params(tx), torch.float64, device="cpu")
    assert gt.analysis(torch.ones((3,) + gt.spatial_shape, dtype=torch.float64)).shape == (
        gt.spectral_shape)


def test_modal_filter_matches(tmp_path):
    """The ring-masked radial factor on the a cos(lat) mask, 1e-12."""
    (mj, gj, _), (mt, gt, _) = build_pair(SW, tmp_path)
    spec = np.random.default_rng(3).normal(size=gt.spectral_shape)
    for axes in ("rl", "l"):
        fj = jmodel.build_modal_filter(gj, 3000.0, 4, mj.ts, jnp.float64, axes=axes)
        ft = tmodel.build_modal_filter(gt, 3000.0, 4, mt.ts, torch.float64, axes=axes)
        per_var_close(ft(torch.from_numpy(spec)), fj(jnp.asarray(spec)), 1e-12, axes)


# -------------------------------------------------------- the equation sets


def _hs_extras(grid, ctx, pkg_np):
    """ctx.extras['hs_grad'] from the case-5 cone, as each package's example
    builds it."""
    pts = grid.gridpoints()
    _, _, _, hs = wm.w5_fields(pts[:, 0], pts[:, 1])
    return pkg_np.setup_topography(grid, ctx, hs.reshape(grid.spatial_shape))


@pytest.mark.parametrize("name", ["sw", "sw_diffusion", "sw_topography", "advection"])
def test_tendencies_match(name, tmp_path):
    case = {"sw": SW, "sw_diffusion": SW_K, "sw_topography": SW, "advection": ADV}[name]
    if name != "sw_topography":
        rj, rt = tendency_pair(case, tmp_path)
    else:
        (mj, gj, cj), (mt, gt, ct) = build_pair(case, tmp_path)
        fj = _hs_extras(gj, cj, jwm)
        ft = _hs_extras(gt, ct, wm)
        assert np.abs(ft - np.asarray(fj)).max() <= 1e-12 * np.abs(fj).max()
        per_var_close(ct.extras["hs_grad"], cj.extras["hs_grad"], 1e-12, "hs_grad")
        rng = np.random.default_rng(0)
        fields = {k: rng.normal(size=(3,) + gt.spatial_shape) * np.array(
            [8000.0, 50.0, 20.0])[:, None, None] * (1.0 if k == "val" else 0.1)
            for k in gt.field_keys}
        rj = jget(case.eqset)({k: jnp.asarray(a) for k, a in fields.items()}, cj)
        rt = tget(case.eqset)(
            {k: torch.from_numpy(a) for k, a in fields.items()}, ct)
    assert_results_close(rj, rt)


@pytest.mark.parametrize("name", ["sw", "sw_diffusion", "advection"])
def test_twenty_steps_match(name, tmp_path):
    case = {"sw": SW, "sw_diffusion": SW_K, "advection": ADV}[name]
    pj, pt, _ = step_pair(case, tmp_path, 20)
    per_var_close(pt, pj, 1e-9, name)


def test_topography_extras_and_twenty_steps_match(tmp_path):
    """options['topography_file'] in each package's initialize, the extras
    compared and carried across by convert, then 20 steps from them."""
    case = Case(**{**SW.__dict__, "ic": w5_ic, "ts": 200.0})
    gt = tx.create_grid(case.gp(tx), torch.float64, device="cpu")
    pts = gt.gridpoints()
    _, _, _, hs = wm.w5_fields(pts[:, 0], pts[:, 1])
    topo = tmp_path / "topo.csv"
    np.savetxt(topo, np.concatenate([pts, hs[:, None]], axis=1), delimiter=",",
               header="lat,lon,hs", comments="", fmt="%.17g")
    sw_ics = sw_csv(tmp_path / "ics.csv", gt, w5_ic)
    runs = []
    for pkg, mod, dtype, kw in ((jx, jmodel, jnp.float64, {}),
                                (tx, tmodel, torch.float64, {"device": "cpu"})):
        m = wm.build_model(ts=200.0, t_end=4000.0) if pkg is tx else jwm.build_model(
            ts=200.0, t_end=4000.0)
        m = m.with_(initial_conditions=str(sw_ics), output_dir=str(tmp_path / "out"),
                    grid_params=case.gp(pkg), options={"topography_file": str(topo)})
        g, c, s = mod.initialize(m, dtype, **kw)
        runs.append((m, g, c, s, mod, dtype))
    (mj, gj, cj, sj, _, _), (mt, gt, ct, st, _, _) = runs
    for k in ("hs_grad", "hs_filtered"):
        per_var_close(np.asarray(ct.extras[k])[None], np.asarray(cj.extras[k])[None], 1e-12, k)
    carried = convert.context_extras_from_numpy(cj.extras, device="cpu")
    assert sorted(carried) == ["hs_filtered", "hs_grad"]
    for k, v in carried.items():
        assert v.dtype == torch.float64
        per_var_close(v[None], ct.extras[k][None], 1e-12, k)
    sj = jmodel.make_scan(jmodel.build_step(mj, gj, cj, jnp.float64), 20)(sj)
    ct.extras.update(carried)
    st = tmodel.make_scan(tmodel.build_step(mt, gt, ct, torch.float64), 20)(st)
    per_var_close(gt.synthesis(st.spec)["val"], gj.synthesis(sj.spec)["val"], 1e-9)


def test_topography_needs_its_extras(tmp_path):
    (_, _, _), (mt, gt, ct) = build_pair(SW, tmp_path, 1, {"topography_file": "hs.csv"})
    with pytest.raises(ValueError, match="hs_grad"):
        tmodel.build_step(mt, gt, ct, torch.float64)


# ---------------------------------------- the gates of tests/test_sphere.py


def sw_csv(path, grid, ic):
    pts = grid.gridpoints()
    cols = ic(pts, ("h", "u", "v"))
    np.savetxt(path, np.concatenate([pts, np.stack([cols["h"], cols["u"], cols["v"]], 1)], 1),
               delimiter=",", header="lat,lon,h,u,v", comments="", fmt="%.17g")
    return path


def _grid(model):
    grid = tx.create_grid(model.grid_params, torch.float64, device="cpu")
    pts = grid.gridpoints()
    return grid, pts[:, 0].reshape(grid.spatial_shape), pts[:, 1].reshape(grid.spatial_shape)


def _quad():
    return jbspline.mish_weights(-np.pi / 2, np.pi / 2, 32)


def test_sl_transform_roundtrip():
    grid, phi, lam = _grid(wm.build_model())
    f = (np.sin(phi) ** 2 + 0.3 * np.cos(phi) ** 4 * np.cos(4 * lam)
         + 0.1 * np.cos(phi) * np.sin(lam))
    phys = np.stack([f, 0.5 * f, np.zeros_like(f)])
    out = grid.synthesis(grid.analysis(torch.from_numpy(phys)))["val"].numpy()
    assert np.abs(out[0] - f).max() < 2e-3 * np.abs(f).max()


def test_sl_pole_rings_near_axisymmetric():
    grid, _, _ = _grid(wm.build_model())
    mask = grid.ring_mask.numpy()
    assert mask[0].sum() <= 5
    assert mask[mask.shape[0] // 2].sum() > 40


def test_williamson2_steady_state():
    model = wm.build_model(ts=300.0)
    grid, phi, _ = _grid(model)
    h2, u2, v2 = wm.w2_fields(phi)
    _, out = wm.run_case(model, np.stack([h2, u2, v2]), 5 * 288, grid=grid, device="cpu")
    assert np.isfinite(out).all()
    l2 = np.sqrt(np.mean((out[0] - h2) ** 2)) / np.sqrt(np.mean(h2**2))
    assert l2 < 5.0e-4, l2
    assert np.abs(out[2]).max() < 0.05, np.abs(out[2]).max()
    assert abs(out[1].max() - u2.max()) < 0.2


def test_williamson6_rossby_haurwitz():
    model = wm.build_model(ts=150.0)
    grid, phi, lam = _grid(model)
    h6, u6, v6 = wm.w6_fields(phi, lam)
    _, out = wm.run_case(model, np.stack([h6, u6, v6]), 576, grid=grid, device="cpu")
    assert np.isfinite(out).all()
    h_an, _, _ = wm.w6_fields(phi, lam - wm.w6_phase_speed() * 86400.0)
    corr = np.corrcoef(out[0].ravel(), h_an.ravel())[0, 1]
    assert corr > 0.999, corr
    corr0 = np.corrcoef(out[0].ravel(), h6.ravel())[0, 1]
    assert corr > corr0 + 0.0005, (corr, corr0)
    w_quad = _quad()
    m0 = float((h6 * np.cos(phi) * w_quad[:, None]).sum())
    m1 = float((out[0] * np.cos(phi) * w_quad[:, None]).sum())
    assert abs(m1 - m0) / abs(m0) < 5e-6, (m0, m1)


def test_williamson1_cross_polar_advection():
    a = wm.A_EARTH
    model = wm.build_model(ts=300.0).with_(
        equation_set="AdvectionSphere",
        physical_params={"u0": 2 * np.pi * a / (12 * 86400.0), "alpha": np.pi / 2},
    )
    grid, phi, lam = _grid(model)
    h0 = wm.w1_bell(phi, lam)
    phys0 = np.zeros((3,) + grid.spatial_shape)
    phys0[0] = h0
    _, out = wm.run_case(model, phys0, int(12 * 86400 / 300), grid=grid, device="cpu")
    assert np.isfinite(out).all()
    l2 = np.sqrt(np.mean((out[0] - h0) ** 2)) / np.sqrt(np.mean(h0**2))
    assert l2 < 0.55, l2
    assert out[0].max() > 500.0, out[0].max()
    w = np.maximum(out[0], 0.0)
    lam_c = np.angle(np.sum(w * np.exp(1j * lam))) % (2 * np.pi)
    assert abs(lam_c - 1.5 * np.pi) < 0.25, lam_c
    phi_c = (w * phi).sum() / w.sum()
    assert abs(phi_c) < 0.15, phi_c


def test_williamson5_mountain_flow():
    model = wm.build_model(ts=200.0)
    grid, phi, lam = _grid(model)
    ctx = tmodel.build_context(model, grid, torch.float64)
    h5, u5, v5, hs = wm.w5_fields(phi, lam)
    hs_f = wm.setup_topography(grid, ctx, hs)
    _, out = wm.run_case(model, np.stack([h5, u5, v5]), 5 * 432, grid=grid, ctx=ctx,
                         device="cpu")
    assert np.isfinite(out).all()
    surf = out[0] + hs_f
    dev = surf - surf.mean(axis=1, keepdims=True)
    rms = float(np.sqrt((dev**2).mean()))
    assert 15.0 < rms < 120.0, rms
    assert 25.0 < out[1].max() < 45.0, out[1].max()
    w_quad = _quad()
    m0 = float((h5 * np.cos(phi) * w_quad[:, None]).sum())
    m1 = float((out[0] * np.cos(phi) * w_quad[:, None]).sum())
    assert abs(m1 - m0) / abs(m0) < 1e-5, (m0, m1)


def test_topography_file_driver_path(tmp_path):
    model = wm.build_model(ts=200.0, t_end=2000.0).with_(
        initial_conditions=str(tmp_path / "ics.csv"),
        output_dir=str(tmp_path / "out"),
        options={"topography_file": str(tmp_path / "topo.csv")},
    )
    grid, phi, lam = _grid(model)
    pts = grid.gridpoints()
    sw_csv(model.initial_conditions, grid, w5_ic)
    _, _, _, hs = wm.w5_fields(pts[:, 0], pts[:, 1])
    np.savetxt(tmp_path / "topo.csv", np.concatenate([pts, hs[:, None]], axis=1),
               delimiter=",", header="lat,lon,hs", comments="", fmt="%.17g")
    _, phys = tx.integrate_model(model, write_outputs=False, dtype=torch.float64,
                                 device="cpu")
    assert np.isfinite(phys).all()
    assert np.abs(phys[2]).max() > 0.1, np.abs(phys[2]).max()


# ------------------------------------------------- Williamson 2, the CLI model


def test_williamson2_model_is_the_models_configuration(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "w2_model_jax", os.path.join(os.path.dirname(__file__), "..", "models",
                                     "williamson2_sphere.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mj, mt = mod.model, wm.williamson2_model(str(tmp_path))
    for k in ("ts", "integration_time", "output_interval", "equation_set"):
        assert getattr(mt, k) == getattr(mj, k)
    assert mt.phys() == mj.phys() and mt.opts() == mj.opts()
    for k in ("geometry", "xmin", "xmax", "num_cells", "lDim", "sphere_radius", "vars"):
        assert getattr(mt.grid_params, k) == getattr(mj.grid_params, k), k
    mod.write_ics(str(tmp_path / "jax_ics.csv"))
    a = np.loadtxt(tmp_path / "jax_ics.csv", delimiter=",", skiprows=1)
    b = np.loadtxt(mt.initial_conditions, delimiter=",", skiprows=1)
    per_var_close(b.T, a.T, 1e-12)
    # two hours of it through integrate_model, against the JAX package
    short = mt.with_(integration_time=7200.0, output_interval=3600.0)
    _, pt = tx.integrate_model(short, dtype=torch.float64, device="cpu")
    _, pj = jx.integrate_model(
        mj.with_(integration_time=7200.0, output_interval=3600.0,
                 initial_conditions=str(tmp_path / "jax_ics.csv"),
                 output_dir=str(tmp_path / "jax_out")), dtype=jnp.float64)
    per_var_close(pt, pj, 1e-9)
    assert sorted(f for f in os.listdir(tmp_path) if f.startswith("physical_out")) == [
        "physical_out_0.0.csv", "physical_out_3600.0.csv", "physical_out_7200.0.csv"]
