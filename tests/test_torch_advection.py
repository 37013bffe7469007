"""The linear-advection sets of scythe_tpu_torch: the three end-to-end tests
of tests/test_advection_e2e.py run on the port, and LinearAdvection1D / RZ /
RL / RLZ against scythe_tpu (float64 on the CPU, inputs from a seed with
numpy): one call on random fields within 1e-12 of each variable's max|ref|,
20 steps within 1e-9.
"""

import numpy as np
import pytest
import torch

from scythe_tpu_torch import BC, GridParameters, ModelParameters, create_grid, integrate_model
from scythe_tpu_torch import io as sio
from scythe_tpu_torch.basis import bspline as bs

from test_torch_shallow_water import (
    Case, assert_results_close, per_var_close, step_pair, tendency_pair,
)

torch.set_num_threads(2)


def make_advection_model(tmp_path, num_cells=100, ts=0.05, T=100.0):
    gp = GridParameters(
        geometry="R",
        xmin=-50.0,
        xmax=50.0,
        num_cells=num_cells,
        BCL={"u": BC.PERIODIC},
        BCR={"u": BC.PERIODIC},
        vars={"u": 1},
    )
    model = ModelParameters(
        ts=ts,
        integration_time=T,
        output_interval=T / 2,
        equation_set="LinearAdvection1D",
        initial_conditions=str(tmp_path / "ics.csv"),
        output_dir=str(tmp_path / "out"),
        grid_params=gp,
        physical_params={"c_0": 1.0, "K": 0.0},
    )
    grid = create_grid(gp, torch.float64, device="cpu")
    r = grid.r_mish
    u0 = np.exp(-((r / 20.0) ** 2))  # sigma = 20 Gaussian
    with open(model.initial_conditions, "w") as f:
        f.write("r,u\n")
        for ri, ui in zip(r, u0):
            f.write(f"{ri},{ui}\n")
    return model, u0


def test_gaussian_round_trip(tmp_path):
    model, u0 = make_advection_model(tmp_path)
    grid, phys = integrate_model(model, dtype=torch.float64, device="cpu")
    l2 = np.sqrt(np.sum((phys[0] - u0) ** 2))
    assert l2 < 2e-2, l2
    out0 = tmp_path / "out" / "physical_out_0.0.csv"
    outT = tmp_path / "out" / "physical_out_100.0.csv"
    assert out0.exists() and outT.exists()
    names0, data0 = sio._read_csv(str(out0))
    assert names0 == ["r", "u"]
    assert data0.shape == (300, 2)


def test_diffusion_decays_gaussian(tmp_path):
    model, u0 = make_advection_model(tmp_path, T=10.0)
    model = model.with_(physical_params={"c_0": 0.0, "K": 1.0})
    grid, phys = integrate_model(model, dtype=torch.float64, write_outputs=False,
                                 device="cpu")
    u_final = phys[0]
    assert u_final.max() < u0.max()
    assert u_final.max() > 0.5 * u0.max()
    # diffusion preserves the integral on a periodic domain
    wts = bs.mish_weights(-50.0, 50.0, 100)
    assert np.isclose(np.sum(wts * u_final), np.sum(wts * u0), rtol=1e-6)


def test_nan_watchdog(tmp_path):
    model, u0 = make_advection_model(tmp_path, T=15.0)
    # unstable diffusion coefficient -> NaN/overflow should raise
    model = model.with_(physical_params={"c_0": 0.0, "K": -50.0})
    with pytest.raises(FloatingPointError):
        integrate_model(model, dtype=torch.float64, write_outputs=False, device="cpu")


# ------------------------------------------------------- against scythe_tpu


def _grid(geometry, names, **kw):
    def gp(pkg):
        extra = dict(kw)
        if geometry == "R":
            extra.update(BCL={"u": pkg.BC.PERIODIC}, BCR={"u": pkg.BC.PERIODIC})
        else:
            extra.update(BCL={"h": pkg.BC.R1T1})
        return pkg.GridParameters(geometry=geometry, vars=names, **extra)

    return gp


def _blob(pts, names):
    """A blob off the axis carried by a solid-body rotation and an updraft."""
    r = pts[:, 0]
    out = {"u": np.exp(-(((r - 50.0) / 20.0) ** 2))}
    if "h" in names:
        out = {"h": np.exp(-(((r - 50.0) / 20.0) ** 2)), "u": 0.3 + 0.0 * r,
               "v": 2.0 * np.pi / 100.0 * r, "w": 0.5 + 0.0 * r}
    return out


CASES = {
    "LinearAdvection1D": Case(
        "LinearAdvection1D", _grid("R", ("u",), xmin=0.0, xmax=100.0, num_cells=24),
        {"c_0": 1.0, "K": 0.5}, ts=0.05, ic=_blob),
    "LinearAdvectionRZ": Case(
        "LinearAdvectionRZ",
        _grid("RZ", ("h", "u", "v", "w"), xmin=0.0, xmax=100.0, num_cells=10, zmin=0.0,
              zmax=100.0, zDim=12),
        {"K": 0.5}, ts=0.05, ic=_blob),
    "LinearAdvectionRL": Case(
        "LinearAdvectionRL",
        _grid("RL", ("h", "u", "v"), xmin=0.0, xmax=100.0, num_cells=10, lDim=16),
        {"K": 0.5}, ts=0.05, ic=_blob),
    "LinearAdvectionRL_K0": Case(
        "LinearAdvectionRL",
        _grid("RL", ("h", "u", "v"), xmin=0.0, xmax=100.0, num_cells=10, lDim=16),
        {"K": 0.0}, ts=0.05, ic=_blob),
    "LinearAdvectionRLZ": Case(
        "LinearAdvectionRLZ",
        _grid("RLZ", ("h", "u", "v"), xmin=0.0, xmax=100.0, num_cells=8, lDim=16,
              zmin=0.0, zmax=50.0, zDim=8),
        {"K": 0.5}, ts=0.05, ic=_blob),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_tendencies_match(name, tmp_path):
    rj, rt = tendency_pair(CASES[name], tmp_path)
    assert_results_close(rj, rt)
    assert rt.impdot is None and not rt.overrides


@pytest.mark.parametrize("name", sorted(CASES))
def test_twenty_steps_match(name, tmp_path):
    pj, pt, _ = step_pair(CASES[name], tmp_path, 20)
    per_var_close(pt, pj, 1e-9, name)
    assert np.abs(pt[0]).max() > 0.1
