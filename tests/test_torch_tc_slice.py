"""The mature-TC slice: scythe_tpu_torch against scythe_tpu.

The option bundle of models/tc_mature_rlz.py (MoistEulerRLZ, semi-implicit,
diagnostic condensation capped at 2e-4 with tau 30 s, Smagorinsky Cs 0.2
with implicit vertical diffusion, bulk surface fluxes, a 100 km radial
sponge) at the reduced size of tests/test_tc_intensification.py (16 cells,
ts 4 s), float64 on the CPU, started in both packages from one IC CSV
written by the JAX example.  Tolerances, relative to each variable's
max|ref|: the IC CSVs and the option builders (Smagorinsky, surface fluxes,
implicit vertical diffusion, sponge) 1e-12; one step's tendencies 1e-10;
20 steps' fields 1e-9 (the tests/test_golden.py bar).
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
from scythe_tpu.physics import turbulence as jtb

import scythe_tpu_torch as tx
from scythe_tpu_torch import convert
from scythe_tpu_torch import io as tio
from scythe_tpu_torch import model as tmodel
from scythe_tpu_torch import timeintegration as tti
from scythe_tpu_torch.examples import tc_intensification_rlz as tct
from scythe_tpu_torch.ops import column_solve, rlz_analysis
from scythe_tpu_torch.physics import turbulence as ttb

torch.set_num_threads(2)

_spec = importlib.util.spec_from_file_location(
    "tc_example_jax",
    os.path.join(os.path.dirname(__file__), "..", "examples", "tc_intensification_rlz.py"),
)
tcj = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tcj)

N_STEPS = 20
KW = dict(num_cells=16, ts=4.0, t_end=N_STEPS * 4.0, stable=True, cap=2.0e-4,
          rh=0.9, qv0=20.0, smag=0.2, ivd=True, cond_tau=30.0)
ICS = dict(vmax=15.0, moist_core=0.85, moist_core_depth=10000.0)


def _assert_per_var(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    for v in range(ref.shape[0]):
        scale = np.abs(ref[v]).max()
        err = np.abs(got[v] - ref[v]).max()
        assert err <= rel * scale, (v, err, scale)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX run: its IC CSV and its states after 0, 1, 10 and 20 steps."""
    tmp = tmp_path_factory.mktemp("tc_slice")
    mj = tcj.build_model(str(tmp / "jax"), **KW).with_(output_interval=N_STEPS * 4.0)
    gj = jx.create_grid(mj.grid_params, jnp.float64)
    tcj.write_ics(mj, gj, jmodel.build_context(mj, gj, jnp.float64).ref_state, **ICS)
    gj, cj, sj = jmodel.initialize(mj, jnp.float64)
    step = jax.jit(jmodel.build_step(mj, gj, cj, jnp.float64))
    states = {0: sj}
    for n in range(1, N_STEPS + 1):
        sj = step(sj)
        if n in (1, 10, N_STEPS):
            states[n] = sj
    mt = tct.build_model(str(tmp / "torch"), **KW).with_(
        output_interval=N_STEPS * 4.0, initial_conditions=mj.initial_conditions
    )
    return dict(tmp=tmp, mj=mj, gj=gj, cj=cj, states=states, mt=mt)


def test_write_ics_matches_jax(case):
    mt = case["mt"].with_(initial_conditions=str(case["tmp"] / "torch" / "ics.csv"))
    gt = tx.create_grid(mt.grid_params, torch.float64, device="cpu")
    tct.write_ics(mt, gt, tmodel.build_context(mt, gt, torch.float64).ref_state, **ICS)
    with open(mt.initial_conditions) as f:
        header = f.readline().strip()
    assert header == "r,l,z," + ",".join(tct.VARS)
    a = np.loadtxt(case["mj"].initial_conditions, delimiter=",", skiprows=1)
    b = np.loadtxt(mt.initial_conditions, delimiter=",", skiprows=1)
    _assert_per_var(b.T, a.T, 1e-12)
    assert 14.0 < b[:, 3 + 4].max() < 16.0  # the 15 m/s vortex


def test_one_step_tendencies_match(case):
    mt = case["mt"]
    gt, ct, st = tmodel.initialize(mt, torch.float64, device="cpu")
    _assert_per_var(ct.extras["sponge_ref"], case["cj"].extras["sponge_ref"], 1e-12)
    st1 = tmodel.build_step(mt, gt, ct, torch.float64)(st)
    sj, sj1 = case["states"][0], case["states"][1]
    _assert_per_var(st.spec, sj.spec, 1e-12)
    _assert_per_var(st1.expdot_nm1, sj1.expdot_nm1, 1e-10)
    _assert_per_var(st1.impdot_nm1, sj1.impdot_nm1, 1e-10)
    _assert_per_var(st1.spec, sj1.spec, 1e-10)


def test_twenty_steps_match(case):
    before = (column_solve.launches, rlz_analysis.launches)
    _, phys_t = tx.integrate_model(case["mt"], dtype=torch.float64, device="cpu")
    assert (column_solve.launches, rlz_analysis.launches) == before  # CPU: plain
    assert np.isfinite(phys_t).all()
    ref = case["gj"].synthesis(case["states"][N_STEPS].spec)["val"]
    _assert_per_var(phys_t, ref, 1e-9)
    outs = sorted(f for f in os.listdir(case["mt"].output_dir) if f.startswith("physical_out"))
    assert outs == ["physical_out_0.0.csv", "physical_out_80.0.csv"]


def test_run_continues_in_the_port_from_jax_state(case):
    """JAX 10 steps, the port 10 more from that state and the JAX context
    extras (the sponge's reference), against JAX 20 steps."""
    mt = case["mt"]
    gt, ct, _ = tmodel.initialize(mt, torch.float64, device="cpu")
    extras = convert.context_extras_from_numpy(case["cj"].extras, device="cpu")
    assert set(extras) == {"sponge_ref"}
    ct.extras.update(extras)
    st = convert.state_from_numpy(case["states"][10], device="cpu")
    step = tmodel.build_step(mt, gt, ct, torch.float64)
    for _ in range(N_STEPS - 10):
        st = step(st)
    sj = case["states"][N_STEPS]
    assert st.t == int(sj.t)
    _assert_per_var(
        gt.synthesis(st.spec)["val"], case["gj"].synthesis(sj.spec)["val"], 1e-9
    )


@pytest.fixture(scope="module")
def fields(case):
    """One set of synthesized fields (the JAX package's, as numpy) handed to
    both packages' builders."""
    f = case["gj"].synthesis(case["states"][10].spec)
    return {k: np.array(v) for k, v in f.items()}


@pytest.fixture(scope="module")
def grids(case):
    gt = tx.create_grid(case["mt"].grid_params, torch.float64, device="cpu")
    return case["gj"], gt


def test_length_scales_match(grids):
    gj, gt = grids
    assert np.array_equal(ttb.ring_arc_spacing(gt), np.asarray(jtb.ring_arc_spacing(gj)))
    for a, b in zip(ttb.length_scales(gt), jtb.length_scales(gj)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("mode", ["isotropic", "split_vertical", "horizontal_only"])
def test_smagorinsky_matches_jax(case, grids, fields, mode):
    gj, gt = grids
    r = np.asarray(case["cj"].coords["r"])
    dr, dl, dz = fields["dr"], fields["dl"], fields["dz"]

    def args(lib):
        a = lib.asarray if lib is jnp else torch.from_numpy
        vel = [(a(dr[i]), a(dl[i] / r), a(dz[i])) for i in (3, 4, 5)]
        n2 = None if mode == "horizontal_only" else a(9.81 / 1004.0 * (dz[0] + 1e-3))
        return vel, n2

    kw = {"split_vertical": mode == "split_vertical",
          "horizontal_only": mode == "horizontal_only"}
    vj, n2j = args(jnp)
    vt, n2t = args(torch)
    kj = jtb.smagorinsky_viscosity(gj, 4.0, 0.2, *vj, jnp.float64, n2=n2j, **kw)
    kt = ttb.smagorinsky_viscosity(gt, 4.0, 0.2, *vt, torch.float64, n2=n2t, **kw)
    pairs = list(zip(kt, kj)) if mode == "split_vertical" else [(kt, kj)]
    for got, want in pairs:
        want = np.asarray(want)
        assert want.max() > 0.0
        assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()


def test_surface_fluxes_match_jax(case, grids, fields):
    gj, gt = grids
    ct = tmodel.build_context(case["mt"], gt, torch.float64)
    cfg = dict(case["cj"].options["surface_fluxes"])
    aj = jmodel.build_surface_fluxes(gj, case["cj"], cfg, jnp.float64)
    at = tmodel.build_surface_fluxes(gt, ct, cfg, torch.float64)
    expdot = np.random.default_rng(3).normal(size=fields["val"].shape)
    want = np.asarray(aj(jnp.asarray(expdot), jnp.asarray(fields["val"])))
    got = at(torch.from_numpy(expdot.copy()), torch.from_numpy(fields["val"]))
    _assert_per_var(got, want, 1e-12)
    assert np.abs(want - expdot).max() > 0.0  # the fluxes did add something


def test_implicit_vdiff_matches_jax(grids):
    gj, gt = grids
    rng = np.random.default_rng(4)
    var = rng.normal(size=(gt.nvars,) + gt.spatial_shape)
    k_v = 50.0 + 500.0 * rng.random(gt.spatial_shape)
    want = np.asarray(jmodel.build_implicit_vdiff(gj, jnp.float64)(
        jnp.asarray(var), jnp.asarray(k_v), 4.0))
    got = tmodel.build_implicit_vdiff(gt, torch.float64)(
        torch.from_numpy(var.copy()), torch.from_numpy(k_v), 4.0)
    _assert_per_var(got, want, 1e-12)
    # xi and qss are left as they were
    assert np.array_equal(got[1].numpy(), var[1]) and np.array_equal(got[8].numpy(), var[8])


def test_vdiff_exclude_takes_a_bare_string(case, grids):
    """A bare string names one variable (the JAX package's tuple(...) splits
    it into characters; ROADMAP queue 3)."""
    _, gt = grids
    rng = np.random.default_rng(6)
    var = torch.from_numpy(rng.normal(size=(gt.nvars,) + gt.spatial_shape))
    k_v = torch.from_numpy(50.0 + 500.0 * rng.random(gt.spatial_shape))
    results = [
        tmodel.build_implicit_vdiff(gt, torch.float64, exclude)(var.clone(), k_v, 4.0)
        for exclude in ("w", ("w",), "mu_c", ("mu_c",))
    ]
    assert torch.equal(results[0], results[1])
    assert torch.equal(results[2], results[3])
    assert torch.equal(results[0][5], var[5]) and torch.equal(results[2][6], var[6])
    assert not torch.equal(results[0][1], var[1])  # xi is diffused once not excluded
    # and through the options: a multi-letter name builds and steps
    mt = case["mt"].with_(options={**case["mt"].opts(), "vdiff_exclude": "mu_c"})
    g, c, s = tmodel.initialize(mt, torch.float64, device="cpu")
    assert torch.isfinite(tmodel.build_step(mt, g, c, torch.float64)(s).spec).all()
    bad = mt.with_(options={**mt.opts(), "vdiff_exclude": "nope"})
    c_bad = tmodel.build_context(bad, g, torch.float64)
    c_bad.extras.update(c.extras)
    with pytest.raises(ValueError, match="unknown variable 'nope'"):
        tmodel.build_step(bad, g, c_bad, torch.float64)


def test_sponge_matches_jax(case):
    """The sponge's term of the tendency: one step's expdot with the sponge
    minus without it, in each package."""
    def expdot(pkg, mod, dtype, sponge):
        opts = {k: v for k, v in case["mj"].opts().items()
                if k not in ("sponge_width", "sponge_tau")}
        if sponge:
            opts.update(sponge_width=100.0e3, sponge_tau=1800.0)
        m = (case["mj"] if pkg is jx else case["mt"]).with_(options=opts)
        g, c, s = (mod.initialize(m, dtype) if pkg is jx
                   else mod.initialize(m, dtype, device="cpu"))
        s = s._replace(spec=s.spec * 1.02)  # away from the sponge's reference
        return np.asarray(mod.build_step(m, g, c, dtype)(s).expdot_nm1)

    want = expdot(jx, jmodel, jnp.float64, True) - expdot(jx, jmodel, jnp.float64, False)
    got = expdot(tx, tmodel, torch.float64, True) - expdot(tx, tmodel, torch.float64, False)
    assert np.abs(want).max() > 0.0
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize(
    "options,named",
    [({"topography_file": "hs.csv"}, "topography_file"),
     ({"checkpoint_interval": 4.0}, "checkpoint_interval"),
     ({"si_mode": "variable"}, "si_mode")],
    ids=["topography_file", "checkpoint_interval", "si_mode"],
)
def test_options_beside_the_bundle_still_raise(case, options, named):
    """Each option on top of the bundle builds in both packages, and one
    step through integrate_model agrees within 1e-12 of each field's max, as
    do the topography's extras and the checkpoint the step writes."""
    opts = dict(options)
    gt = tx.create_grid(case["mt"].grid_params, torch.float64, device="cpu")
    if named == "topography_file":
        pts = gt.gridpoints()
        opts[named] = str(case["tmp"] / "hs.csv")
        hs = 30.0 * np.exp(-((pts[:, 0] - 1.0e5) / 5.0e4) ** 2) * (1.0 + np.sin(pts[:, 1]))
        np.savetxt(opts[named], np.concatenate([pts, hs[:, None]], axis=1), delimiter=",",
                   header="r,l,z,hs", comments="", fmt="%.17g")
    out, ctxs, dirs = {}, {}, {}
    for pkg, mod, dtype, kw, key in ((jx, jmodel, jnp.float64, {}, "mj"),
                                     (tx, tmodel, torch.float64, {"device": "cpu"}, "mt")):
        dirs[pkg] = str(case["tmp"] / f"{named}_{pkg.__name__}")
        m = case[key].with_(options={**case[key].opts(), **opts}, integration_time=4.0,
                            output_interval=4.0, output_dir=dirs[pkg])
        _, ctxs[pkg], _ = mod.initialize(m, dtype, **kw)
        _, out[pkg] = pkg.integrate_model(m, dtype=dtype, **kw)
    _assert_per_var(out[tx], out[jx], 1e-12)
    assert sorted(ctxs[tx].extras) == sorted(ctxs[jx].extras)
    for k, v in ctxs[jx].extras.items():
        _assert_per_var(ctxs[tx].extras[k][None], np.asarray(v)[None], 1e-12)
    assert ("hs_grad" in ctxs[tx].extras) == (named == "topography_file")
    ckpts = [sorted(f for f in os.listdir(dirs[pkg]) if f.endswith(".npz")) for pkg in (jx, tx)]
    assert ckpts[0] == ckpts[1] == (["checkpoint_4.0.npz"] if named == "checkpoint_interval"
                                    else [])
    for name in ckpts[1]:
        with np.load(os.path.join(dirs[jx], name)) as a, \
                np.load(os.path.join(dirs[tx], name)) as b:
            for k in a.files:
                _assert_per_var(np.atleast_1d(b[k])[None], np.atleast_1d(a[k])[None], 1e-12)


@pytest.mark.parametrize(
    "options",
    [{"sponge_top_width": 4000.0, "sponge_top_vars": ("v", "w")},
     {"radiation_width": 50.0e3, "radiation_speed": 50.0},
     {"modal_filter_tau": 30.0, "modal_filter_axes": "l"},
     {"incremental_analysis": True}],
    ids=["sponge_top_width", "radiation_width", "modal_filter_tau", "incremental_analysis"],
)
def test_options_beside_the_bundle_run(case, options):
    """The options ported after the bundle, each on top of it: three steps in
    both packages, 1e-9 of each field's max|ref|."""
    finals = []
    for pkg, mod, dtype, kw, key in ((jx, jmodel, jnp.float64, {}, "mj"),
                                     (tx, tmodel, torch.float64, {"device": "cpu"}, "mt")):
        m = case[key].with_(options={**case[key].opts(), **options})
        g, c, s = mod.initialize(m, dtype, **kw)
        step = mod.build_step(m, g, c, dtype)
        for _ in range(3):
            s = step(s)
        finals.append(np.asarray(g.synthesis(s.spec)["val"]))
    ref, got = finals
    for v in range(ref.shape[0]):
        assert np.abs(got[v] - ref[v]).max() <= 1e-9 * np.abs(ref[v]).max(), v


def test_profile_runs_tc_rlz(tmp_path):
    """tests/test_profile.py's gate on the port: moist_production (with its
    variable-coefficient solve) integrates the TC configuration at 12 cells
    300 steps to a finite state with the vortex intact."""
    model = tct.build_model(str(tmp_path), num_cells=12, ts=2.0, t_end=600.0, fluxes=True)
    model = model.with_(options={**model.opts(), "profile": "moist_production"})
    assert model.opts()["si_mode"] == "variable"
    grid = tx.create_grid(model.grid_params, torch.float64, device="cpu")
    ctx = tmodel.build_context(model, grid, torch.float64)
    tct.write_ics(model, grid, ctx.ref_state)
    phys0 = tio.read_physical_grid(model.initial_conditions, grid)
    spec0 = grid.analysis(torch.from_numpy(phys0))
    ctx.extras["sponge_ref"] = grid.synthesis(spec0)["val"]
    state = tti.initial_state(spec0, (grid.nvars,) + grid.spatial_shape, torch.float64)
    out = tmodel.make_scan(tmodel.build_step(model, grid, ctx, torch.float64), 300)(state)
    phys = grid.synthesis(out.spec)["val"].numpy()
    assert np.isfinite(phys).all()
    assert phys[4].max() > 8.0


def test_tc_mature_model_is_the_named_configuration(tmp_path):
    m = tct.tc_mature_model(str(tmp_path), t_end=1800.0, output_interval=900.0)
    gp = m.grid_params
    assert (gp.num_cells, gp.rDim, gp.b_rDim, gp.lDim, gp.zDim, gp.nvars) == (
        100, 300, 103, 4, 24, 9)
    o = m.opts()
    assert o["smagorinsky"] == 0.2 and o["implicit_vdiff"] is True
    assert o["condensation"] == "diagnostic" and o["condensation_rate_cap"] == 2.0e-4
    assert o["condensation_tau"] == 30.0 and o["sponge_width"] == 100.0e3
    assert dict(o["surface_fluxes"])["sst"] == tct.SST
    assert (m.ts, m.num_ts, m.output_int) == (2.0, 900, 450)
    assert os.path.exists(m.initial_conditions)
