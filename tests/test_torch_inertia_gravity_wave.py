"""tests/test_inertia_gravity_wave.py's gates on the port: the Skamarock &
Klemp (1994) inertia-gravity wave (scythe_tpu_torch.examples.
inertia_gravity_wave) at its published size (150 cells x 24 levels, ts
0.75 s, 3000 s), float64 on the CPU, held to the JAX test's bands: the
correlation with the linear Boussinesq solution above 0.84 and the
extrema within 25%, the energy centroid within 10 km of the analytic
drift, the 20 m/s mean flow kept to 0.01 m/s (its departures under 0.2).
"""

import numpy as np
import pytest
import torch

import scythe_tpu_torch as tx
from scythe_tpu_torch import model as tmodel
from scythe_tpu_torch.examples import inertia_gravity_wave as igw
from scythe_tpu_torch.examples.straka_density_current import snapshots

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def igw_run(tmp_path_factory):
    model = igw.build_model(str(tmp_path_factory.mktemp("igw")), num_cells=150, nz=24,
                            ts=0.75, t_end=3000.0)
    grid = tx.create_grid(model.grid_params, torch.float64, device="cpu")
    igw.write_ics(model, grid, tmodel.build_context(model, grid, torch.float64).ref_state)
    grid, ctx, runs = snapshots(model, 1, torch.float64, "cpu")
    return grid, ctx, runs[-1][1]


def test_igw_matches_analytic_dispersion(igw_run):
    """test_inertia_gravity_wave.py:43."""
    grid, ctx, phys = igw_run
    assert np.isfinite(phys).all()
    thp = igw.theta_pert(phys, grid, ctx.ref_state)
    th_an = igw.analytic_theta_pert(grid, 3000.0)
    corr = igw.correlation(thp, th_an)
    assert corr > 0.84, corr
    assert 0.75 < thp.max() / th_an.max() < 1.25, (thp.max(), th_an.max())
    assert 0.75 < thp.min() / th_an.min() < 1.25, (thp.min(), th_an.min())


def test_igw_doppler_drift(igw_run):
    """test_inertia_gravity_wave.py:55."""
    grid, ctx, phys = igw_run
    cen = igw.energy_centroid_x(igw.theta_pert(phys, grid, ctx.ref_state), grid)
    cen_an = igw.energy_centroid_x(igw.analytic_theta_pert(grid, 3000.0), grid)
    assert abs(cen - cen_an) < 10000.0, (cen, cen_an)


def test_igw_mean_flow_preserved(igw_run):
    """test_inertia_gravity_wave.py:64."""
    grid, ctx, phys = igw_run
    u = np.asarray(phys[3]).reshape(grid.spatial_shape)
    assert abs(u.mean() - igw.U_MEAN) < 0.01, u.mean()
    assert np.abs(u - igw.U_MEAN).max() < 0.2, np.abs(u - igw.U_MEAN).max()
