"""The shallow-water equation sets of scythe_tpu_torch against scythe_tpu.

Float64 on the CPU, inputs from a seed with numpy.  Tolerances, relative to
each variable's max|ref|: one call of an equation set on random fields 1e-12
(tendencies and overrides); a run of steps 1e-9 (the tests/test_golden.py
bar).  The flagship two-way slab model is also held against the stored
golden trajectory, tests/golden/twoway_slab_50steps_f64.npz.

The helpers here (``Case``, ``tendency_pair``, ``step_pair``) carry one
configuration through both packages; the other equation-set test files of
the port import them.
"""

import os
from dataclasses import dataclass, field
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scythe_tpu as jx
from scythe_tpu import model as jmodel
from scythe_tpu import timeintegration as jti
from scythe_tpu.equations.common import get_equation_set as jget

import scythe_tpu_torch as tx
from scythe_tpu_torch import convert
from scythe_tpu_torch import model as tmodel
from scythe_tpu_torch import timeintegration as tti
from scythe_tpu_torch.equations.common import get_equation_set as tget
from scythe_tpu_torch.examples import cha_bell_initialization as cb

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "twoway_slab_50steps_f64.npz")


@dataclass
class Case:
    """One configuration, built alike in both packages."""

    eqset: str
    gp: Callable  # package -> GridParameters
    params: dict
    ts: float
    ic: Callable  # (points [n, ndim], var names) -> {name: values [n]}
    options: dict = field(default_factory=dict)
    sounding: bool = False  # needs a reference-state file
    # std of the random fields handed to the equation set, by variable (a
    # float for all), and of every derivative slot relative to it
    val_scale: object = 1.0
    deriv_scale: float = 1.0e-3
    abs_vars: tuple = ()  # variables whose random value is made non-negative


def write_sounding(path):
    zs = np.linspace(0.0, 12000.0, 40)
    theta = 300.0 + 0.004 * zs
    qv = 14.0 * np.exp(-zs / 2500.0)
    with open(path, "w") as f:
        f.write(f"1015.0 {theta[0]} {qv[0]}\n")
        for z, th, q in zip(zs[1:], theta[1:], qv[1:]):
            f.write(f"{z} {th} {q}\n")
    return str(path)


def per_var_close(got, ref, rel, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    for v in range(ref.shape[0]):
        scale = np.abs(ref[v]).max()
        err = np.abs(got[v] - ref[v]).max()
        assert err <= rel * scale, (what, v, err, scale)


def build_pair(case: Case, tmp, n_steps=1, options=None):
    """((model, grid, ctx) of the JAX package, the same of the port)."""
    out = []
    snd = write_sounding(tmp / "sounding.txt") if case.sounding else ""
    for pkg, mod, dtype, kw in ((jx, jmodel, jnp.float64, {}),
                                (tx, tmodel, torch.float64, {"device": "cpu"})):
        model = pkg.ModelParameters(
            ts=case.ts,
            integration_time=n_steps * case.ts,
            output_interval=n_steps * case.ts,
            equation_set=case.eqset,
            initial_conditions=str(tmp / "ics.csv"),
            output_dir=str(tmp / f"out_{pkg.__name__}"),
            ref_state_file=snd,
            grid_params=case.gp(pkg),
            physical_params=case.params,
            options={**case.options, **(options or {})},
        )
        grid = pkg.create_grid(model.grid_params, dtype, **kw)
        out.append((model, grid, mod.build_context(model, grid, dtype)))
    return out


def initial_phys(case: Case, grid) -> np.ndarray:
    names = grid.params.vars
    cols = case.ic(grid.gridpoints(), names)
    phys = np.zeros((len(names),) + grid.spatial_shape)
    for v, n in enumerate(names):
        if n in cols:
            phys[v] = np.asarray(cols[n], np.float64).reshape(grid.spatial_shape)
    return phys


def tendency_pair(case: Case, tmp, seed=0):
    """The equation set called once in each package on the same random
    fields; returns (EqResult of the JAX package, of the port)."""
    (mj, gj, cj), (mt, gt, ct) = build_pair(case, tmp)
    rng = np.random.default_rng(seed)
    names = gt.params.vars
    shape = (len(names),) + gt.spatial_shape
    scale = np.array([case.val_scale[n] if isinstance(case.val_scale, dict)
                      else case.val_scale for n in names])
    scale = scale.reshape((-1,) + (1,) * len(gt.spatial_shape))
    fields = {}
    for k in gt.field_keys:
        a = rng.normal(size=shape) * scale * (1.0 if k == "val" else case.deriv_scale)
        if k == "val":
            for n in case.abs_vars:
                a[names.index(n)] = np.abs(a[names.index(n)])
        fields[k] = a
    rj = jget(case.eqset)({k: jnp.asarray(a) for k, a in fields.items()}, cj)
    given = {k: torch.from_numpy(a.copy()) for k, a in fields.items()}
    rt = tget(case.eqset)(given, ct)
    for k, a in fields.items():  # an equation set leaves its inputs alone
        assert np.array_equal(given[k].numpy(), a), k
    return rj, rt


def assert_results_close(rj, rt, rel=1e-12):
    per_var_close(rt.expdot, rj.expdot, rel, "expdot")
    assert (rt.impdot is None) == (rj.impdot is None)
    if rj.impdot is not None:
        per_var_close(rt.impdot, rj.impdot, rel, "impdot")
    assert sorted(rt.overrides) == sorted(rj.overrides)
    for v in rj.overrides:
        per_var_close(rt.overrides[v][None], np.asarray(rj.overrides[v])[None], rel,
                      f"override {v}")


def step_pair(case: Case, tmp, n_steps, options=None):
    """``n_steps`` from the case's initial fields in each package, through
    initialize's own pieces (analysis, boundary references, initial state);
    returns (final fields of the JAX package, of the port, port state)."""
    (mj, gj, cj), (mt, gt, ct) = build_pair(case, tmp, n_steps, options)
    phys0 = initial_phys(case, gt)
    shape = (gt.nvars,) + gt.spatial_shape

    spec_j = gj.analysis(jnp.asarray(phys0))
    jmodel._set_boundary_refs(cj, gj, spec_j)
    sj = jti.initial_state(spec_j, shape, jnp.float64,
                           imp_rows=jmodel.imp_history_rows(mj))
    step_j = jax.jit(jmodel.build_step(mj, gj, cj, jnp.float64))
    for _ in range(n_steps):
        sj = step_j(sj)

    spec_t = gt.analysis(torch.from_numpy(phys0))
    tmodel._set_boundary_refs(ct, gt, spec_t)
    st = tti.initial_state(spec_t, shape, torch.float64,
                           imp_rows=tmodel.imp_history_rows(mt))
    st = tmodel.make_scan(tmodel.build_step(mt, gt, ct, torch.float64), n_steps)(st)
    assert st.t == int(sj.t) == n_steps + 1
    pj = np.asarray(gj.synthesis(sj.spec)["val"])
    pt = gt.synthesis(st.spec)["val"].numpy()
    assert np.isfinite(pt).all()
    return pj, pt, st


# ---------------------------------------------------------------- the cases


def rl_grid(cells=8, ldim=16, xmax=3.0e5):
    def gp(pkg):
        BC = pkg.BC
        return pkg.GridParameters(
            geometry="RL", xmin=0.0, xmax=xmax, num_cells=cells, lDim=ldim,
            BCL={"h": BC.R1T1, "u": BC.R1T0, "v": BC.R1T0, "ub": BC.R1T0,
                 "vb": BC.R1T0, "wb": BC.R1T1},
            BCR={"h": BC.R0, "u": BC.R1T1, "v": BC.R0, "ub": BC.R1T1, "vb": BC.R0,
                 "wb": BC.R0},
            vars={"h": 1, "u": 2, "v": 3, "ub": 4, "vb": 5, "wb": 6},
        )

    return gp


def hvu_grid(geometry, cells=10, ldim=16, xmax=1.0e5):
    def gp(pkg):
        BC = pkg.BC
        kw = {"lDim": ldim} if geometry == "RL" else {}
        names = ("h", "u", "v") if geometry == "RL" else ("h", "u")
        return pkg.GridParameters(
            geometry=geometry, xmin=0.0, xmax=xmax, num_cells=cells,
            BCL={"h": BC.R1T1, "u": BC.R1T0, "v": BC.R1T0},
            BCR={"h": BC.R0, "u": BC.R1T1, "v": BC.R0},
            vars=names, **kw,
        )

    return gp


def hrbl_grid(pkg):
    BC = pkg.BC
    return pkg.GridParameters(
        geometry="RLZ", xmin=0.0, xmax=2.0e5, num_cells=16, lDim=16,
        zmin=0.0, zmax=2000.0, zDim=12,
        BCL={"h": BC.R1T1, "u": BC.R1T0, "v": BC.R1T0, "ub": BC.R1T0, "vb": BC.R1T0,
             "wb": BC.R1T1},
        BCR={"h": BC.R0, "u": BC.R1T1, "v": BC.R0, "ub": BC.R1T1, "vb": BC.R0},
        vars={"h": 1, "u": 2, "v": 3, "ub": 4, "vb": 5, "wb": 6},
    )


def vortex_ic(pts, names, rm=5.0e4, vm=20.0, wave=0.05):
    """A Rankine vortex with a wavenumber-2 part and its balanced height."""
    r = pts[:, 0]
    lam = pts[:, 1]
    v = np.where(r < rm, vm * r / rm, vm * rm / r) * (1.0 + wave * np.cos(2 * lam))
    r_u = np.unique(r)
    v_u = np.where(r_u < rm, vm * r_u / rm, vm * rm / r_u)
    dh = (5.0e-5 * v_u + v_u**2 / r_u) / 9.81
    h_u = np.concatenate([[0.0], np.cumsum(0.5 * (dh[1:] + dh[:-1]) * np.diff(r_u))])
    return {"h": h_u[np.searchsorted(r_u, r)], "v": v, "vb": 0.8 * v}


def bump_ic(pts, names):
    """A height bump off the axis, at rest."""
    r = pts[:, 0]
    lam = pts[:, 1] if pts.shape[1] > 1 else 0.0
    return {"h": 10.0 * np.exp(-(((r - 4.0e4) / 1.5e4) ** 2)) * (1.0 + 0.3 * np.cos(lam))}


SLAB_PARAMS = {"g": 9.81, "K": 5000.0, "Cd": 2.4e-3, "Hfree": 2000.0, "Hb": 1000.0,
               "f": 5.0e-5}
SLAB_SCALES = {"h": 30.0, "u": 5.0, "v": 20.0, "ub": 5.0, "vb": 20.0, "wb": 0.1}

CASES = {
    "LinearShallowWater1D": Case(
        "LinearShallowWater1D", hvu_grid("R"), {"g": 9.81, "K": 100.0, "H": 100.0},
        ts=5.0, ic=bump_ic, val_scale=5.0),
    "LinearShallowWaterRL": Case(
        "LinearShallowWaterRL", hvu_grid("RL"), {"g": 9.81, "K": 100.0, "H": 100.0},
        ts=5.0, ic=bump_ic, val_scale=5.0),
    "ShallowWaterRL": Case(
        "ShallowWaterRL", hvu_grid("RL"),
        {"g": 9.81, "K": 100.0, "H": 100.0, "f": 5.0e-5}, ts=5.0, ic=bump_ic,
        val_scale=5.0),
    "Oneway_ShallowWater_Slab": Case(
        "Oneway_ShallowWater_Slab", rl_grid(), SLAB_PARAMS, ts=3.0, ic=vortex_ic,
        val_scale=SLAB_SCALES),
    "Twoway_ShallowWater_Slab": Case(
        "Twoway_ShallowWater_Slab", rl_grid(), {**SLAB_PARAMS, "S1": 1.0e-5}, ts=3.0,
        ic=vortex_ic, val_scale=SLAB_SCALES),
    "Oneway_ShallowWater_HeightResolvedBL": Case(
        "Oneway_ShallowWater_HeightResolvedBL", hrbl_grid,
        {"g": 9.81, "Kh": 3000.0, "Cd": 2.4e-3, "Hfree": 2000.0, "f": 5.0e-5,
         "Um": 3.0, "Vm": -2.0},
        ts=0.2, ic=lambda pts, names: vortex_ic(pts, names, wave=0.0) | {
            "vb": vortex_ic(pts, names, wave=0.0)["v"]},
        # winds wide enough for all three branches of the drag law (5.2 and
        # 33.6 m/s); vertical shear of a boundary layer
        val_scale={"h": 30.0, "u": 5.0, "v": 20.0, "ub": 12.0, "vb": 25.0, "wb": 0.1},
        deriv_scale=1.0e-2),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_tendencies_match(name, tmp_path):
    rj, rt = tendency_pair(CASES[name], tmp_path)
    assert_results_close(rj, rt)
    assert float(rt.expdot.abs().max()) > 0.0


def test_height_resolved_bl_takes_every_drag_branch(tmp_path):
    """The random winds of the tendency test reach all three branches of the
    wind-speed dependent drag law, and the surface flux sits in level 0 of a
    tensor of its own."""
    case = CASES["Oneway_ShallowWater_HeightResolvedBL"]
    rng = np.random.default_rng(0)
    u10 = np.hypot(rng.normal(size=4000) * 12.0 + 3.0, rng.normal(size=4000) * 25.0 - 2.0)
    assert (u10 < 5.2).any() and ((u10 >= 5.2) & (u10 < 33.6)).any() and (u10 >= 33.6).any()
    rj, rt = tendency_pair(case, tmp_path, seed=3)
    assert rt.overrides[5].shape == rt.expdot.shape[1:]


@pytest.mark.parametrize("name", sorted(set(CASES) - {"Oneway_ShallowWater_HeightResolvedBL"}))
def test_ten_steps_match(name, tmp_path):
    pj, pt, _ = step_pair(CASES[name], tmp_path, 10)
    per_var_close(pt, pj, 1e-9, name)


def test_height_resolved_bl_twenty_steps_match(tmp_path):
    case = CASES["Oneway_ShallowWater_HeightResolvedBL"]
    case = Case(**{**case.__dict__, "params": {**case.params, "Um": 0.0, "Vm": 0.0}})
    pj, pt, _ = step_pair(case, tmp_path, 20)
    per_var_close(pt, pj, 1e-9)
    assert np.abs(pt[5]).max() > 0.0  # the wb override reached the state


# ------------------------------------------------------- the flagship model


def _flagship_run(n_steps=50):
    model = cb.flagship_model(32, 32)
    grid = tx.create_grid(model.grid_params, torch.float64, device="cpu")
    ctx = tmodel.build_context(model, grid, torch.float64)
    step = tmodel.build_step(model, grid, ctx, torch.float64)
    out = tmodel.make_scan(step, n_steps)(cb.vortex_state(grid, torch.float64))
    return model, grid, out


def _jax_flagship():
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from __graft_entry__ import _flagship_model, _vortex_phys, _vortex_state

    return _flagship_model, _vortex_phys, _vortex_state


def test_flagship_model_is_the_jax_one():
    jflag, jphys, _ = _jax_flagship()
    mj, mt = jflag(num_cells=32, nl=32), cb.flagship_model(32, 32)
    for k in ("ts", "integration_time", "output_interval", "equation_set"):
        assert getattr(mt, k) == getattr(mj, k)
    assert mt.phys() == mj.phys()
    gj, gt = mj.grid_params, mt.grid_params
    for k in ("geometry", "xmin", "xmax", "num_cells", "lDim", "vars"):
        assert getattr(gt, k) == getattr(gj, k)
    assert [b.name for b in gt.BCL] == [b.name for b in gj.BCL]
    assert [b.name for b in gt.BCR] == [b.name for b in gj.BCR]
    grid_t = tx.create_grid(gt, torch.float64, device="cpu")
    grid_j = jx.create_grid(gj, jnp.float64)
    assert np.array_equal(cb.vortex_phys(grid_t), jphys(grid_j))


def test_flagship_golden_trajectory():
    """50 steps of Twoway_ShallowWater_Slab reproduce the stored float64
    fields at 1e-9 of each field's max: the bar of tests/test_golden.py."""
    model, grid, out = _flagship_run()
    phys = grid.synthesis(out.spec)["val"].numpy()
    ref = np.load(GOLDEN)["phys"]
    assert ref.shape == phys.shape == (6, 96, 32)
    for v, n in enumerate(model.grid_params.vars):
        scale = np.abs(ref[v]).max() + 1e-12
        err = np.abs(phys[v] - ref[v]).max() / scale
        assert err < 1e-9, f"{n}: max rel field err {err:.2e}"


def test_flagship_fifty_steps_match_jax():
    jflag, _, jstate = _jax_flagship()
    mj = jflag(num_cells=32, nl=32)
    gj = jx.create_grid(mj.grid_params, jnp.float64, matmul="plain")
    cj = jmodel.build_context(mj, gj, jnp.float64)
    out_j = jmodel.make_scan(jmodel.build_step(mj, gj, cj, jnp.float64), 50)(
        jstate(gj, jnp.float64))
    _, gt, out_t = _flagship_run()
    per_var_close(out_t.spec, out_j.spec, 1e-9, "spec")
    per_var_close(out_t.expdot_nm1, out_j.expdot_nm1, 1e-9, "expdot_nm1")
    per_var_close(gt.synthesis(out_t.spec)["val"], gj.synthesis(out_j.spec)["val"], 1e-9)


def test_jax_state_continues_in_the_port():
    """A state made by the JAX package (mid-run, its histories filled) moves
    across through convert.state_from_numpy and both go on for ten steps."""
    jflag, _, jstate = _jax_flagship()
    mj = jflag(num_cells=32, nl=32)
    gj = jx.create_grid(mj.grid_params, jnp.float64)
    step_j = jax.jit(jmodel.build_step(mj, gj, jmodel.build_context(mj, gj, jnp.float64),
                                       jnp.float64))
    sj = jstate(gj, jnp.float64)
    for _ in range(5):
        sj = step_j(sj)
    st = convert.state_from_numpy(sj, "cpu")
    assert st.t == 6 and st.spec.dtype == torch.float64
    mt = cb.flagship_model(32, 32)
    gt = tx.create_grid(mt.grid_params, torch.float64, device="cpu")
    step_t = tmodel.build_step(mt, gt, tmodel.build_context(mt, gt, torch.float64),
                               torch.float64)
    for _ in range(10):
        sj = step_j(sj)
    st = tmodel.make_scan(step_t, 10)(st)
    assert st.t == int(sj.t) == 16
    for k in ("spec", "expdot_nm1", "expdot_nm2"):
        per_var_close(getattr(st, k), getattr(sj, k), 1e-9, k)


def test_override_does_not_write_into_the_synthesis(tmp_path):
    """The step patches wb into a copy: the synthesized value it read the
    fields from is what a second synthesis of the same coefficients gives."""
    model, grid, out = _flagship_run(3)
    ctx = tmodel.build_context(model, grid, torch.float64)
    fields = grid.synthesis(out.spec)
    before = fields["val"].clone()
    res = tget("Twoway_ShallowWater_Slab")(fields, ctx)
    assert torch.equal(fields["val"], before)
    assert 5 in res.overrides and not torch.equal(res.overrides[5], before[5])


def test_make_scan_is_the_loop_of_steps():
    model, grid, out3 = _flagship_run(3)
    step = tmodel.build_step(model, grid, tmodel.build_context(model, grid, torch.float64),
                             torch.float64)
    state = cb.vortex_state(grid, torch.float64)
    for _ in range(3):
        state = step(state)
    assert torch.equal(state.spec, out3.spec) and state.t == out3.t == 4
    assert tmodel.make_scan(step, 0)(state) is state
