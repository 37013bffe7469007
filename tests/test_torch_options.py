"""The step options ported with the explicit main path, scythe_tpu_torch
against scythe_tpu: the modal filter (its application to random
coefficients within 1e-12 of each variable's max|ref|, on R, RL, RZ and RLZ
grids, for the axes "rlz", "rl", "r" and "l", with a periodic radial BC
among them), and ten steps with the top sponge, the radiation boundary, the
modal filter and the incremental closing analysis within 1e-9 (float64 on
the CPU, inputs from a seed with numpy).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scythe_tpu import model as jmodel

from scythe_tpu_torch import convert
from scythe_tpu_torch import model as tmodel

import test_torch_advection as adv
import test_torch_rz_models as rz
import test_torch_shallow_water as sw
from test_torch_shallow_water import Case, build_pair, per_var_close, step_pair

torch.set_num_threads(2)

MOIST_VARS = ("s", "xi", "mu", "u", "v", "w", "mu_c", "mu_r", "qss")


def _moist_rlz_grid(pkg):
    BC = pkg.BC
    return pkg.GridParameters(
        geometry="RLZ", xmin=0.0, xmax=10000.0, num_cells=8, lDim=8, zmin=0.0,
        zmax=10000.0, zDim=12, BCL={"u": BC.R1T0, "v": BC.R1T0, "w": BC.R1T1},
        BCR={"u": BC.R1T0, "v": BC.R0}, vars=MOIST_VARS,
    )


def _bubble3d(pts, names):
    r, lam, z = pts[:, 0], pts[:, 1], pts[:, 2]
    rad = np.sqrt(((r * np.cos(lam) - 4000.0) / 1500.0) ** 2
                  + (r * np.sin(lam) / 1500.0) ** 2 + ((z - 2000.0) / 1500.0) ** 2)
    return {"s": 3.0 * np.maximum(0.0, np.cos(np.pi * np.minimum(rad, 1.0) / 2.0)) ** 2}


MOIST_RLZ = Case("MoistEulerRLZ", _moist_rlz_grid, {"K": 10.0, "f": 5.0e-5}, ts=0.25,
                 ic=_bubble3d, options={"semiimplicit": True}, sounding=True)

GRIDS = {
    "R_periodic": adv.CASES["LinearAdvection1D"],
    "R": rz.CASES["Williams2013_slabTCBL"],
    "RL": sw.CASES["Twoway_ShallowWater_Slab"],
    "RZ": rz.CASES["Euler_test"],
    "RLZ": sw.CASES["Oneway_ShallowWater_HeightResolvedBL"],
}


@pytest.mark.parametrize("order", [4, 8])
@pytest.mark.parametrize("axes", ["rlz", "rl", "r", "l", "z"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_modal_filter_matches(grid, axes, order, tmp_path):
    (mj, gj, _), (mt, gt, _) = build_pair(GRIDS[grid], tmp_path)
    fj = jmodel.build_modal_filter(gj, 30.0, order, mj.ts, jnp.float64, axes=axes)
    ft = tmodel.build_modal_filter(gt, 30.0, order, mt.ts, torch.float64, axes=axes)
    spec = np.random.default_rng(7).normal(size=gt.spectral_shape)
    given = torch.from_numpy(spec.copy())
    got = ft(given).numpy()
    assert np.array_equal(given.numpy(), spec)
    per_var_close(got, fj(jnp.asarray(spec)), 1e-12, (grid, axes))
    acts = any(a in axes for a in grid.split("_")[0].lower())
    assert np.array_equal(got, spec) != acts


RUNS = {
    "top_sponge_rz": (rz.CASES["Euler_test"],
                      {"sponge_top_width": 3000.0, "sponge_top_tau": 20.0}),
    "top_sponge_vars_rz": (rz.CASES["Euler_test"],
                           {"sponge_top_width": 3000.0, "sponge_top_tau": 20.0,
                            "sponge_top_vars": ("u", "w")}),
    "top_and_radial_sponge_rlz": (MOIST_RLZ,
                                  {"sponge_top_width": 3000.0, "sponge_top_vars": ["w"],
                                   "sponge_width": 3000.0, "sponge_tau": 30.0}),
    "top_sponge_rlz": (sw.CASES["Oneway_ShallowWater_HeightResolvedBL"],
                       {"sponge_top_width": 500.0, "sponge_top_tau": 5.0}),
    "radiation_slab": (sw.CASES["Twoway_ShallowWater_Slab"], {"radiation_width": 8.0e4}),
    "radiation_speed_and_sponge": (sw.CASES["ShallowWaterRL"],
                                   {"radiation_width": 3.0e4, "radiation_speed": 25.0,
                                    "sponge_width": 2.0e4, "sponge_tau": 100.0}),
    "radiation_1d": (sw.CASES["LinearShallowWater1D"], {"radiation_width": 3.0e4}),
    "filter_rl": (sw.CASES["Twoway_ShallowWater_Slab"], {"modal_filter_tau": 30.0}),
    "filter_rz_order8": (rz.CASES["rainfall_test"],
                         {"modal_filter_tau": 5.0, "modal_filter_order": 8}),
    "filter_rlz_l": (MOIST_RLZ, {"modal_filter_tau": 5.0, "modal_filter_axes": "l"}),
    "filter_periodic": (adv.CASES["LinearAdvection1D"], {"modal_filter_tau": 1.0}),
    "incremental_slab": (sw.CASES["Twoway_ShallowWater_Slab"],
                         {"incremental_analysis": True}),
    "incremental_moist_rlz": (MOIST_RLZ, {"incremental_analysis": True}),
    "incremental_filter_sponge_rlz": (
        sw.CASES["Oneway_ShallowWater_HeightResolvedBL"],
        {"incremental_analysis": True, "modal_filter_tau": 10.0,
         "modal_filter_axes": "rl", "sponge_top_width": 500.0}),
    # the production profile with its variable-coefficient solve passed over
    "moist_production_constant_si": (MOIST_RLZ, {"profile": "moist_production",
                                                 "si_mode": "constant"}),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_ten_steps_with_option_match(name, tmp_path):
    case, options = RUNS[name]
    pj, pt, _ = step_pair(case, tmp_path, 10, options)
    per_var_close(pt, pj, 1e-9, name)
    # and the option acted: the same run without it ends elsewhere
    _, plain, _ = step_pair(case, tmp_path, 10)
    assert np.abs(pt - plain).max() > 0.0 or name.startswith("incremental")


@pytest.mark.parametrize("case", [rz.CASES["Williams2013_slabTCBL"],
                                  rz.CASES["Kepert2017_TCBL"]], ids=lambda c: c.eqset)
def test_incremental_analysis_equals_the_classical_close(case, tmp_path):
    """spec + A(var_np1 - S spec) is A(var_np1) where A S = I: on R and RZ
    grids without the spline penalty (l_q = 0).  With the penalty, or with the
    r-dependent ring mask of an RL or RLZ grid, the analysis also smooths, and
    the classical close smooths the standing state again each step.  On a set
    with an override the delta is taken against the synthesis value, not the
    patched field, or the two would differ by A(override - S spec)."""
    exact = dataclasses.replace(
        case, gp=lambda pkg: dataclasses.replace(case.gp(pkg), l_q=0.0))
    _, classical, _ = step_pair(exact, tmp_path, 10)
    _, incremental, _ = step_pair(exact, tmp_path, 10, {"incremental_analysis": True})
    # 1e-12 of the state's max: the override's variable (u or ub, ~1e-4 of
    # it here) carries the round-off of the large fields it is diagnosed from
    assert np.abs(incremental - classical).max() <= 1e-12 * np.abs(classical).max()
    # with the penalty the option changes the run, in both packages alike
    pj, pt, _ = step_pair(case, tmp_path, 10, {"incremental_analysis": True})
    _, smoothed, _ = step_pair(case, tmp_path, 10)
    per_var_close(pt, pj, 1e-9)
    assert np.abs(pt - smoothed).max() > 1e-6 * np.abs(smoothed).max()


def test_boundary_references_cross_over(tmp_path):
    """The JAX package's sponge and radiation references through
    convert.context_extras_from_numpy are what the port builds itself."""
    case = sw.CASES["Twoway_ShallowWater_Slab"]
    options = {"radiation_width": 8.0e4, "sponge_width": 5.0e4}
    (mj, gj, cj), (mt, gt, ct) = build_pair(case, tmp_path, 1, options)
    phys0 = sw.initial_phys(case, gt)
    jmodel._set_boundary_refs(cj, gj, gj.analysis(jnp.asarray(phys0)))
    tmodel._set_boundary_refs(ct, gt, gt.analysis(torch.from_numpy(phys0)))
    carried = convert.context_extras_from_numpy(cj.extras, device="cpu")
    assert sorted(carried) == sorted(ct.extras) == ["radiation_ref_dr", "sponge_ref"]
    for k, v in carried.items():
        assert v.dtype == torch.float64
        per_var_close(ct.extras[k], v, 1e-12, k)


def test_no_option_no_reference(tmp_path):
    _, (mt, gt, ct) = build_pair(sw.CASES["Twoway_ShallowWater_Slab"], tmp_path)
    tmodel._set_boundary_refs(ct, gt, gt.analysis(torch.zeros((6,) + gt.spatial_shape,
                                                              dtype=torch.float64)))
    assert ct.extras == {}


def test_radiation_speed_is_inferred_or_demanded():
    assert tmodel.infer_radiation_speed({"g": 9.81, "H": 100.0}, {}) == pytest.approx(
        jmodel.infer_radiation_speed({"g": 9.81, "H": 100.0}, {}))
    assert tmodel.infer_radiation_speed({"g": 9.81, "Hfree": 2000.0}, {}) == float(
        np.sqrt(9.81 * 2000.0))
    assert tmodel.infer_radiation_speed({}, {"radiation_speed": 12}) == 12.0
    with pytest.raises(ValueError, match="radiation_speed"):
        tmodel.infer_radiation_speed({"K": 1.0}, {})


@pytest.mark.parametrize(
    "case,options,exc,named",
    [
        (sw.CASES["Twoway_ShallowWater_Slab"], {"sponge_top_width": 100.0}, ValueError,
         "vertical axis"),
        (adv.CASES["LinearAdvection1D"], {"radiation_width": 10.0}, ValueError,
         "radiation_speed"),
        (MOIST_RLZ, {"profile": "moist_production"}, None, "si_mode"),
        (sw.CASES["Twoway_ShallowWater_Slab"], {"checkpoint_interval": 30.0}, None,
         "checkpoint_interval"),
    ],
    ids=["top_sponge_without_z", "radiation_without_speed", "profile_variable_si",
         "checkpoint_interval"],
)
def test_options_that_cannot_build_raise(case, options, exc, named, tmp_path):
    """An option the configuration cannot take raises its error; the cases
    without one (the production profile with its variable-coefficient solve,
    a checkpoint interval) build, and their first step is the JAX package's
    within 1e-12 of each field's max."""
    (mj, gj, cj), (mt, gt, ct) = build_pair(case, tmp_path, 1, options)
    if exc is not None:
        with pytest.raises(exc, match=named):
            tmodel.build_step(mt, gt, ct, torch.float64)
        return
    assert named in mt.opts()
    pj, pt, _ = step_pair(case, tmp_path, 1, options)
    per_var_close(pt, pj, 1e-12, named)


def test_step_without_the_reference_raises(tmp_path):
    """build_step needs the references that initialize() derives."""
    case = dataclasses.replace(sw.CASES["Twoway_ShallowWater_Slab"])
    for options, named in (({"radiation_width": 8.0e4}, "radiation_ref_dr"),
                           ({"sponge_width": 8.0e4}, "sponge_ref")):
        _, (mt, gt, ct) = build_pair(case, tmp_path, 1, options)
        with pytest.raises(ValueError, match=named):
            tmodel.build_step(mt, gt, ct, torch.float64)
