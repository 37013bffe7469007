"""tests/test_straka.py's gates on the port: the Straka et al. (1993)
density current (scythe_tpu_torch.examples.straka_density_current) at the
JAX test's coarse size (64 cells x 32 levels, ts 0.25 s, the full 900 s),
float64 on the CPU, held to its bands: the front (converged 15,537 m;
coarse band 13-17.5 km), theta'_min (converged -9.77 K; band -12 to -5 K)
near the ground, the front advancing at 8-30 m/s, and the configuration's
x-mirror symmetry at 300 s (1e-6 of the field's max).
"""

import numpy as np
import pytest
import torch

import scythe_tpu_torch as tx
from scythe_tpu_torch import model as tmodel
from scythe_tpu_torch.examples import straka_density_current as straka

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def straka_run(tmp_path_factory):
    model = straka.build_model(str(tmp_path_factory.mktemp("straka")), num_cells=64, nz=32,
                               ts=0.25, t_end=900.0)
    grid = tx.create_grid(model.grid_params, torch.float64, device="cpu")
    straka.write_ics(model, grid, tmodel.build_context(model, grid, torch.float64).ref_state)
    grid, ctx, runs = straka.snapshots(model, 3, torch.float64, "cpu")
    return grid, ctx, dict((int(t), phys) for t, phys in runs)


def test_straka_published_diagnostics(straka_run):
    """test_straka.py:55."""
    grid, ctx, snaps = straka_run
    phys = snaps[900]
    assert np.isfinite(phys).all()
    thp = straka.theta_pert(phys, grid, ctx.ref_state)
    front = straka.front_location(thp, grid)
    assert 13000.0 < front < 17500.0, front
    assert -12.0 < thp.min() < -5.0, thp.min()
    _, jmin = np.unravel_index(np.argmin(thp), thp.shape)
    assert grid.z_mish[jmin] < 1500.0, grid.z_mish[jmin]


def test_straka_front_advances(straka_run):
    """test_straka.py:70."""
    grid, ctx, snaps = straka_run
    fronts = [straka.front_location(straka.theta_pert(snaps[t], grid, ctx.ref_state), grid)
              for t in (300, 600, 900)]
    assert fronts[0] < fronts[1] < fronts[2], fronts
    speed = (fronts[2] - fronts[1]) / 300.0
    assert 8.0 < speed < 30.0, speed


def test_straka_symmetry(straka_run):
    """test_straka.py:84: theta' even and u odd in x at 300 s."""
    grid, ctx, snaps = straka_run
    phys = snaps[300]
    thp = straka.theta_pert(phys, grid, ctx.ref_state)
    u = np.asarray(phys[3]).reshape(grid.spatial_shape)
    assert np.allclose(grid.r_mish, -grid.r_mish[::-1], atol=1e-9)
    scale = np.abs(thp).max()
    assert np.abs(thp - thp[::-1]).max() < 1e-6 * scale
    assert np.abs(u + u[::-1]).max() < 1e-6 * np.abs(u).max()
