"""The moist RLZ semi-implicit slice: scythe_tpu_torch against scythe_tpu.

MoistEulerRLZ (semi-implicit, warm rain, condensation adjustment) at a small
size (8 cells, lDim 16, zDim 16, ts 0.25 s) with the off-axis warm bubble of
tests/test_rlz_tcbl.py::test_moist_euler_rlz, float64 on the CPU, started in
both packages from one IC CSV.  Tolerances: one step's tendencies 1e-10 and
20 steps' fields 1e-9, relative to each variable's max|ref|
(the tests/test_golden.py bar).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import scythe_tpu as jx
from scythe_tpu import io as jio
from scythe_tpu import model as jmodel

import scythe_tpu_torch as tx
from scythe_tpu_torch import convert
from scythe_tpu_torch import model as tmodel
from scythe_tpu_torch.ops import column_solve

torch.set_num_threads(2)

VARS = {
    "s": 1, "xi": 2, "mu": 3, "u": 4, "v": 5, "w": 6,
    "mu_c": 7, "mu_r": 8, "qss": 9,
}


def _grid_params(pkg):
    return pkg.GridParameters(
        geometry="RLZ",
        xmin=0.0,
        xmax=10000.0,
        num_cells=8,
        lDim=16,
        zmin=0.0,
        zmax=10000.0,
        zDim=16,
        BCL={"u": pkg.BC.R1T0, "v": pkg.BC.R1T0, "w": pkg.BC.R1T1},
        BCR={"u": pkg.BC.R1T0, "v": pkg.BC.R0},
        vars=VARS,
    )


def _model(pkg, tmp, n_steps, options=None, out="out"):
    return pkg.ModelParameters(
        ts=0.25,
        integration_time=n_steps * 0.25,
        output_interval=10 * 0.25,
        equation_set="MoistEulerRLZ",
        initial_conditions=str(tmp / "ics.csv"),
        output_dir=str(tmp / out),
        ref_state_file=str(tmp / "sounding.txt"),
        grid_params=_grid_params(pkg),
        physical_params={"K": 10.0, "f": 5.0e-5},
        options={"semiimplicit": True, **(options or {})},
    )


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Sounding + bubble IC CSV written once, from the port's grid points."""
    tmp = tmp_path_factory.mktemp("moist_slice")
    zs = np.linspace(0.0, 12000.0, 40)
    theta = 300.0 + 0.004 * zs
    qv = 14.0 * np.exp(-zs / 2500.0)
    with open(tmp / "sounding.txt", "w") as f:
        f.write(f"1015.0 {theta[0]} {qv[0]}\n")
        for z, th, q in zip(zs[1:], theta[1:], qv[1:]):
            f.write(f"{z} {th} {q}\n")
    grid = tx.create_grid(_grid_params(tx), torch.float64, device="cpu")
    pts = grid.gridpoints()
    r, lam, z = pts[:, 0], pts[:, 1], pts[:, 2]
    x, y = r * np.cos(lam), r * np.sin(lam)
    rad = np.sqrt(((x - 4000.0) / 1500.0) ** 2 + (y / 1500.0) ** 2
                  + ((z - 2000.0) / 1500.0) ** 2)
    s_pert = 3.0 * np.maximum(0.0, np.cos(np.pi * np.minimum(rad, 1.0) / 2.0)) ** 2
    cols = np.zeros((len(r), 3 + len(VARS)))
    cols[:, 0], cols[:, 1], cols[:, 2], cols[:, 3] = r, lam, z, s_pert
    np.savetxt(tmp / "ics.csv", cols, delimiter=",", comments="", fmt="%.17g",
               header="r,l,z," + ",".join(VARS))
    return tmp


def _assert_per_var(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    for v in range(ref.shape[0]):
        scale = np.abs(ref[v]).max()
        err = np.abs(got[v] - ref[v]).max()
        assert err <= rel * scale, (v, err, scale)


def test_one_step_tendencies_match(case):
    mj = _model(jx, case, 1)
    gj, cj, sj = jmodel.initialize(mj, jnp.float64)
    sj1 = jmodel.build_step(mj, gj, cj, jnp.float64)(sj)

    mt = _model(tx, case, 1)
    gt, ct, st = tmodel.initialize(mt, torch.float64, device="cpu")
    st1 = tmodel.build_step(mt, gt, ct, torch.float64)(st)

    _assert_per_var(st.spec, sj.spec, 1e-12)
    _assert_per_var(st1.expdot_nm1, sj1.expdot_nm1, 1e-10)
    _assert_per_var(st1.impdot_nm1, sj1.impdot_nm1, 1e-10)
    _assert_per_var(st1.spec, sj1.spec, 1e-10)
    assert st1.t == int(sj1.t) == 2


def test_twenty_steps_match(case):
    _, phys_j = jx.integrate_model(_model(jx, case, 20, out="out_jax"),
                                   dtype=jnp.float64)
    before = column_solve.launches
    _, phys_t = tx.integrate_model(_model(tx, case, 20, out="out_torch"),
                                   dtype=torch.float64, device="cpu")
    assert column_solve.launches == before  # CPU tensors take the plain path
    assert np.isfinite(phys_t).all()
    assert phys_t[5].max() > 0.0  # the bubble starts to rise
    _assert_per_var(phys_t, phys_j, 1e-9)
    # same CSV outputs (t = 0, 2.5, 5.0) in both packages
    for t in ("0.0", "2.5", "5.0"):
        a = np.loadtxt(case / "out_jax" / f"physical_out_{t}.csv", delimiter=",",
                       skiprows=1)
        b = np.loadtxt(case / "out_torch" / f"physical_out_{t}.csv", delimiter=",",
                       skiprows=1)
        _assert_per_var(b.T, a.T, 1e-9)


@pytest.mark.parametrize("profile", [False, True], ids=["si_mode", "moist_production"])
def test_twenty_steps_match_with_variable_si(case, profile):
    """The variable-coefficient solve (a per-level Pxi profile composed into
    the column operator), alone and inside the production profile: 20
    steps at 1e-9 of each field's max, and the run differs from the
    constant-coefficient one."""
    opts = {"profile": "moist_production"} if profile else {"si_mode": "variable"}
    runs = {}
    for pkg, dtype, kw in ((jx, jnp.float64, {}), (tx, torch.float64, {"device": "cpu"})):
        m = _model(pkg, case, 20, opts, out=f"variable_{profile}_{pkg.__name__}")
        runs[pkg] = pkg.integrate_model(m, dtype=dtype, write_outputs=False, **kw)[1]
    _assert_per_var(runs[tx], runs[jx], 1e-9)
    _, constant = tx.integrate_model(_model(tx, case, 20, {"si_mode": "constant"}),
                                     dtype=torch.float64, write_outputs=False, device="cpu")
    assert np.abs(runs[tx] - constant).max() > 0.0


def test_resume_from_jax_checkpoint(case):
    mj = _model(jx, case, 8)
    gj, cj, sj = jmodel.initialize(mj, jnp.float64)
    step_j = jmodel.build_step(mj, gj, cj, jnp.float64)
    for _ in range(3):  # mid-ramp: the next step is the first AB3 step
        sj = step_j(sj)
    path = str(case / "ckpt.npz")
    jio.save_checkpoint(path, sj, 0.75)

    st, t_sim = convert.load_jax_checkpoint(path, "cpu", torch.float64)
    assert t_sim == 0.75 and st.t == 4
    mt = _model(tx, case, 8)
    gt, ct, _ = tmodel.initialize(mt, torch.float64, device="cpu")
    step_t = tmodel.build_step(mt, gt, ct, torch.float64)
    for _ in range(5):
        sj = step_j(sj)
        st = step_t(st)
    _assert_per_var(st.spec, sj.spec, 1e-10)
    _assert_per_var(st.expdot_nm2, sj.expdot_nm2, 1e-10)
    back = convert.state_to_numpy(st)
    assert back["t"] == int(sj.t) == 9
    assert back["impdot_nm1"].shape == np.asarray(sj.impdot_nm1).shape

    # the same 5 steps through the driver, resumed from the JAX checkpoint
    _, phys_t = tx.integrate_model(_model(tx, case, 5, out="out_resume"),
                                   dtype=torch.float64, resume_from=path, device="cpu")
    _assert_per_var(phys_t, gj.synthesis(sj.spec)["val"], 1e-10)
    assert sorted(p.name for p in (case / "out_resume").glob("*.csv")) == [
        "physical_out_2.0.csv"  # t_sim 0.75 + 5 x 0.25; no t=0 output on resume
    ]


def test_state_round_trip(case):
    mj = _model(jx, case, 1)
    _, _, sj = jmodel.initialize(mj, jnp.float64)
    st = convert.state_from_numpy(sj, "cpu")
    assert st.spec.dtype == torch.float64 and st.t == 1
    back = convert.state_to_numpy(st)
    for k in ("spec", "expdot_nm1", "impdot_nm2"):
        assert np.array_equal(back[k], np.asarray(getattr(sj, k)))
    rs = convert.reference_state_from_numpy(jmodel.build_context(
        mj, jx.create_grid(mj.grid_params, jnp.float64), jnp.float64).ref_state, "cpu")
    assert rs.sbar.shape == (16, 3)


@pytest.mark.parametrize(
    "options,named",
    [
        ({"topography_file": "hs.csv"}, "topography_file"),
        ({"checkpoint_interval": 0.5}, "checkpoint_interval"),
        ({"write_spectral": True}, "write_spectral"),
        ({"output_format": "nc"}, "output_format"),
        ({"si_mode": "variable"}, "si_mode"),
        # the production profile: the variable-coefficient solve, diagnostic
        # condensation, the modal filter and exp stiff relaxation together
        ({"profile": "moist_production"}, "si_mode"),
    ],
    ids=lambda o: o if isinstance(o, str) else next(iter(o)),
)
def test_unported_options_raise(case, options, named):
    """The options that once raised build and run here in both packages:
    two steps through integrate_model agree within 1e-12 of each field's
    max, and so do the files and context extras the option makes (the
    topography's filtered gradient, the checkpoint, the spectral and NetCDF
    outputs)."""
    key = next(iter(options))
    opts = dict(options)
    if key == "topography_file":
        grid = tx.create_grid(_grid_params(tx), torch.float64, device="cpu")
        pts = grid.gridpoints()
        hs = 50.0 * np.exp(-((pts[:, 0] - 5000.0) / 3000.0) ** 2) * (1.0 + np.cos(pts[:, 1]))
        opts[key] = str(case / "hs.csv")
        np.savetxt(opts[key], np.concatenate([pts, hs[:, None]], axis=1), delimiter=",",
                   header="r,l,z,hs", comments="", fmt="%.17g")
    out, ctxs = {}, {}
    for pkg, mod, dtype, kw in ((jx, jmodel, jnp.float64, {}),
                                (tx, tmodel, torch.float64, {"device": "cpu"})):
        m = _model(pkg, case, 2, opts, out=f"opt_{key}_{pkg.__name__}")
        _, ctxs[pkg], _ = mod.initialize(m, dtype, **kw)
        _, out[pkg] = pkg.integrate_model(m, dtype=dtype, **kw)
    _assert_per_var(out[tx], out[jx], 1e-12)
    assert sorted(ctxs[tx].extras) == sorted(ctxs[jx].extras)
    for k, v in ctxs[jx].extras.items():
        _assert_per_var(ctxs[tx].extras[k][None], np.asarray(v)[None], 1e-12)
    dirs = {pkg: case / f"opt_{key}_{pkg.__name__}" for pkg in (jx, tx)}
    files = {pkg: sorted(p.name for p in d.iterdir() if p.suffix != ".log")
             for pkg, d in dirs.items()}
    assert files[tx] == files[jx]
    made = {"topography_file": "hs_grad", "checkpoint_interval": "checkpoint_0.5.npz",
            "write_spectral": "spectral_out_0.5.csv", "output_format": "physical_out_0.5.nc"}
    if key in ("checkpoint_interval", "write_spectral", "output_format"):
        assert made[key] in files[tx], files[tx]
    elif key == "topography_file":
        assert "hs_grad" in ctxs[tx].extras
    gt = tx.create_grid(_grid_params(tx), torch.float64, device="cpu")
    for name in files[tx]:
        a, b = (dirs[pkg] / name for pkg in (jx, tx))
        if name.endswith(".npz"):
            with np.load(a) as fa, np.load(b) as fb:
                assert sorted(fa.files) == sorted(fb.files)
                for k in fa.files:
                    _assert_per_var(np.atleast_1d(fb[k])[None], np.atleast_1d(fa[k])[None],
                                    1e-12)
        elif name.startswith("spectral"):
            _assert_per_var(jio._read_csv(str(b))[1].T, jio._read_csv(str(a))[1].T, 1e-12)
        else:
            _assert_per_var(jio.read_physical_grid(str(b), gt),
                            jio.read_physical_grid(str(a), gt), 1e-12)


@pytest.mark.parametrize(
    "options",
    [{"sponge_width": 3000.0}, {"surface_fluxes": {"sst": 300.0}},
     {"implicit_vdiff": True}, {"smagorinsky": 0.2},
     {"sponge_top_width": 1000.0}, {"radiation_width": 1000.0, "radiation_speed": 300.0},
     {"modal_filter_tau": 30.0}, {"incremental_analysis": True}],
    ids=lambda o: next(iter(o)),
)
def test_options_ported_with_the_tc_slice_run(case, options):
    """Options ported with the mature-TC slice and with the explicit main
    path build and step on this configuration too (tests/test_torch_tc_slice.py
    and tests/test_torch_options.py hold them against the JAX package)."""
    m = _model(tx, case, 1, options)
    grid, ctx, state = tmodel.initialize(m, torch.float64, device="cpu")
    out = tmodel.build_step(m, grid, ctx, torch.float64)(state)
    assert torch.isfinite(out.spec).all()


@pytest.mark.parametrize(
    "kw", [{"l_factored": True}, {"deriv_single": True}], ids=lambda k: next(iter(k))
)
def test_unported_grid_switches_raise(kw):
    """The two grid switches that raised before the port had them now run
    and match scythe_tpu on this slice's grid: l_factored=True (the factored
    DFT, plain f64: every slot 1e-12) and deriv_single=True (a compensated
    f32 grid with the fast derivative slots: the value slot 3e-5 of its max,
    the derivative slots one bf16 pass, 1e-2)."""
    import dataclasses

    gpj, gpt = (dataclasses.replace(_grid_params(p), **kw) for p in (jx, tx))
    if "l_factored" in kw:
        gj = jx.create_grid(gpj, jnp.float64, matmul="plain")
        gt = tx.create_grid(gpt, torch.float64, device="cpu")
        dtype, rel, rel_deriv = np.float64, 1e-12, 1e-12
        assert gt.l_fact is not None and gt.kDim == gj.kDim
    else:
        gj = jx.create_grid(gpj, jnp.float32, matmul="compensated")
        gt = tx.create_grid(gpt, torch.float32, matmul="compensated", device="cpu")
        dtype, rel, rel_deriv = np.float32, 3e-5, 1e-2
        assert gt.fast and gj.fast
    phys = np.random.default_rng(0).normal(size=(9,) + gj.spatial_shape).astype(dtype)
    sj = np.asarray(gj.analysis(jnp.asarray(phys)))
    _assert_per_var(gt.analysis(torch.from_numpy(phys)), sj, rel)
    oj, ot = gj.synthesis(jnp.asarray(sj)), gt.synthesis(torch.from_numpy(sj))
    for k in oj:
        _assert_per_var(ot[k], oj[k], rel if k == "val" else rel_deriv)


def test_unported_geometry_and_matmul_raise():
    """What the port refused before it had the factored DFT and the bf16x3
    mode now runs and matches scythe_tpu: a periodic axis past the dense DFT
    (the XYZ box at lDim 4096, factored: operators and a round trip at
    1e-12) and matmul="compensated" (this slice's grid: analysis 3e-5 of
    each field's max); an unknown equation set still raises."""
    from test_torch_xyz import assert_grids_match, assert_round_trip_matches

    kw = dict(geometry="XYZ", num_cells=4, lDim=4096, ymax=1.0, zmax=1.0, zDim=8)
    gj = jx.create_grid(jx.GridParameters(**kw), jnp.float64)
    gt = tx.create_grid(tx.GridParameters(**kw), torch.float64, device="cpu")
    assert gt.l_fact is not None
    assert_grids_match(gj, gt)
    assert_round_trip_matches(gj, gt)
    gj = jx.create_grid(_grid_params(jx), jnp.float32, matmul="compensated")
    gt = tx.create_grid(_grid_params(tx), matmul="compensated", device="cpu")
    assert gt.comp and gt.dtype == torch.float32
    phys = np.random.default_rng(1).normal(size=(9,) + gj.spatial_shape).astype(np.float32)
    _assert_per_var(gt.analysis(torch.from_numpy(phys)),
                    gj.analysis(jnp.asarray(phys)), 3e-5)
    with pytest.raises(KeyError, match="MoistEulerXYZ"):
        from scythe_tpu_torch.equations.common import get_equation_set

        get_equation_set("MoistEulerXYZZ")  # the known sets are listed
