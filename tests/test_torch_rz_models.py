"""The RZ Euler family (Euler_test, BF02_test, rainfall_test) and the
boundary-layer sets (Williams2013_slabTCBL, RL_SlabTCBL, Kepert2017_TCBL) of
scythe_tpu_torch against scythe_tpu: float64 on the CPU, inputs from a seed
with numpy; one call on random fields within 1e-12 of each variable's
max|ref| (tendencies, implicit terms, overrides), 20 steps within 1e-9.
"""

import numpy as np
import pytest
import torch

from test_torch_shallow_water import (
    Case, assert_results_close, per_var_close, step_pair, tendency_pair,
)

torch.set_num_threads(2)

EULER = ("s", "xi", "mu", "u", "w")
# random perturbations in the physical range about the sounding: warm and
# cold, moist and dry (a negative total mu takes the dry branches)
EULER_SCALES = {"s": 2.0, "xi": 0.01, "mu": 2.0e-3, "u": 5.0, "w": 5.0, "mu_l": 1.0e-3,
                "mu_c": 1.0e-3, "mu_r": 1.0e-3, "qss": 1.0e-4}


def _rz_grid(names, cells=10, nz=16):
    def gp(pkg):
        BC = pkg.BC
        return pkg.GridParameters(
            geometry="RZ", xmin=0.0, xmax=10000.0, num_cells=cells, zmin=0.0,
            zmax=10000.0, zDim=nz, BCL={"u": BC.R1T0, "w": BC.R1T1},
            BCR={"u": BC.R1T0}, vars=names,
        )

    return gp


def _bubble(pts, names):
    r, z = pts[:, 0], pts[:, 1]
    rad = np.sqrt((r / 2000.0) ** 2 + ((z - 2000.0) / 2000.0) ** 2)
    return {"s": 3.0 * np.maximum(0.0, np.cos(np.pi * np.minimum(rad, 1.0) / 2.0)) ** 2}


def _tcbl_grid(geometry, **kw):
    def gp(pkg):
        BC = pkg.BC
        return pkg.GridParameters(
            geometry=geometry, xmin=0.0, xmax=2.0e5, num_cells=16,
            BCL={"vgr": BC.R1T0, "u": BC.R1T0, "v": BC.R1T0, "w": BC.R1T1},
            BCR={"vgr": BC.R0, "u": BC.R1T1, "v": BC.R0, "w": BC.R0},
            vars=("vgr", "u", "v", "w"), **kw,
        )

    return gp


def _gradient_wind(pts, names):
    r = pts[:, 0]
    vgr = np.where(r < 5.0e4, 30.0 * r / 5.0e4, 30.0 * 5.0e4 / r)
    return {"vgr": vgr, "v": vgr}


TCBL_PARAMS = {"K": 1500.0, "Cd": 2.4e-3, "h": 1000.0, "f": 5.0e-5}
TCBL_SCALES = {"vgr": 20.0, "u": 5.0, "v": 20.0, "w": 0.1}

CASES = {
    "Euler_test": Case(
        "Euler_test", _rz_grid(EULER), {"K": 5.0}, ts=0.2, ic=_bubble,
        options={"semiimplicit": True}, sounding=True, val_scale=EULER_SCALES),
    "Euler_test_explicit_exact_pgf": Case(
        "Euler_test", _rz_grid(EULER), {"K": 5.0}, ts=0.02, ic=_bubble,
        options={"exact_vertical_pgf": True}, sounding=True, val_scale=EULER_SCALES),
    "BF02_test": Case(
        "BF02_test", _rz_grid(EULER + ("mu_l", "qss")), {"K": 5.0}, ts=0.1, ic=_bubble,
        options={"semiimplicit": True}, sounding=True, val_scale=EULER_SCALES,
        abs_vars=("mu_l",)),
    "BF02_test_diagnostic": Case(
        "BF02_test", _rz_grid(EULER + ("mu_l", "qss")), {"K": 5.0}, ts=0.1, ic=_bubble,
        options={"semiimplicit": True, "condensation": "diagnostic",
                 "exact_vertical_pgf": True, "stiff_relaxation": "exp"},
        sounding=True, val_scale=EULER_SCALES, abs_vars=("mu_l",)),
    "rainfall_test": Case(
        "rainfall_test", _rz_grid(EULER + ("mu_c", "mu_r", "qss")), {"K": 5.0}, ts=0.2,
        ic=_bubble, options={"semiimplicit": True}, sounding=True,
        val_scale=EULER_SCALES, abs_vars=("mu_c", "mu_r")),
    "rainfall_test_production": Case(
        "rainfall_test", _rz_grid(EULER + ("mu_c", "mu_r", "qss")), {"K": 5.0}, ts=0.2,
        ic=_bubble,
        options={"semiimplicit": True, "condensation": "diagnostic",
                 "sedimentation": "active", "stiff_relaxation": "exp",
                 "condensation_rate_cap": 1.0e-4, "exact_vertical_pgf": True},
        sounding=True, val_scale=EULER_SCALES, abs_vars=("mu_c", "mu_r")),
    "Williams2013_slabTCBL": Case(
        "Williams2013_slabTCBL", _tcbl_grid("R"), TCBL_PARAMS, ts=5.0, ic=_gradient_wind,
        val_scale=TCBL_SCALES),
    "RL_SlabTCBL": Case(
        "RL_SlabTCBL", _tcbl_grid("RL", lDim=8), TCBL_PARAMS, ts=5.0, ic=_gradient_wind,
        val_scale=TCBL_SCALES),
    "Kepert2017_TCBL": Case(
        "Kepert2017_TCBL", _tcbl_grid("RZ", zmin=0.0, zmax=2000.0, zDim=12),
        {"K": 1500.0, "Cd": 2.4e-3, "f": 5.0e-5}, ts=0.2, ic=_gradient_wind,
        val_scale=TCBL_SCALES, deriv_scale=1.0e-2),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_tendencies_match(name, tmp_path):
    rj, rt = tendency_pair(CASES[name], tmp_path)
    assert_results_close(rj, rt)
    assert float(rt.expdot.abs().max()) > 0.0


@pytest.mark.parametrize("name", sorted(CASES))
def test_twenty_steps_match(name, tmp_path):
    pj, pt, _ = step_pair(CASES[name], tmp_path, 20)
    per_var_close(pt, pj, 1e-9, name)


@pytest.mark.parametrize("name", ["Williams2013_slabTCBL", "RL_SlabTCBL", "Kepert2017_TCBL"])
def test_boundary_layer_sets_write_w(name, tmp_path):
    """The diagnosed w reaches the state through the override, and the
    surface drag sits in level 0 of a flux tensor of its own."""
    _, pt, _ = step_pair(CASES[name], tmp_path, 5)
    assert np.abs(pt[3]).max() > 0.0 and pt[1].min() < 0.0  # w written, inflow
