"""``harness.write_ics`` writes the program's CSV schema for every geometry the
port has: the coordinate columns named as ``scythe_tpu_torch.io`` names
them, then the variables, so the program reads each variable from its own
column.  The RL and RLZ files are byte for byte those the cells have always
been given."""

import types

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import config as rconfig
from benchmark.reference import grid as rgrid

VARS = {"a": 1, "b": 2, "c": 3}
SPHERE = dict(xmin=-np.pi / 2, xmax=np.pi / 2, num_cells=4, lDim=16)
GRIDS = {
    "R": dict(xmin=0.0, xmax=1.0e4, num_cells=4),
    "RL": dict(xmin=0.0, xmax=1.0e4, num_cells=4, lDim=8),
    "RZ": dict(xmin=0.0, xmax=1.0e4, num_cells=4, zmin=0.0, zmax=1.0e4, zDim=6),
    "RLZ": dict(xmin=0.0, xmax=1.0e4, num_cells=4, lDim=8, zmin=0.0, zmax=1.0e4, zDim=6),
    "XYZ": dict(xmin=0.0, xmax=1.2e4, num_cells=4, lDim=8, ymin=0.0, ymax=8.0e3, zmin=0.0,
                zmax=1.0e4, zDim=6),
    "SL": SPHERE,
    "SLZ": dict(SPHERE, zmin=0.0, zmax=3.0e4, zDim=6),
}


def port_grid(geometry):
    import scythe_tpu_torch as tx

    return tx.create_grid(tx.GridParameters(geometry=geometry, vars=VARS, **GRIDS[geometry]),
                          torch.float64, "plain", device="cpu")


def test_the_table_is_the_programs():
    from scythe_tpu_torch import io as sio

    assert set(harness.COORD_NAMES) == set(GRIDS) == set(sio._COORD_NAMES)
    for geometry, names in harness.COORD_NAMES.items():
        assert list(names) == sio._COORD_NAMES[geometry]


@pytest.mark.parametrize("geometry", sorted(GRIDS))
def test_the_program_reads_back_what_was_written(geometry, tmp_path):
    from scythe_tpu_torch import io as sio

    grid = port_grid(geometry)
    assert grid.gridpoints().shape[1] == len(harness.COORD_NAMES[geometry])
    phys = np.random.default_rng(5).standard_normal((len(VARS),) + grid.spatial_shape)
    path = str(tmp_path / "ics.csv")
    harness.write_ics(path, grid, phys)
    with open(path) as f:
        assert f.readline().strip().split(",") == (
            list(harness.COORD_NAMES[geometry]) + list(VARS))
    assert np.array_equal(sio.read_physical_grid(path, grid), phys)


@pytest.mark.parametrize("geometry", ["RL", "RLZ"])
def test_rl_and_rlz_files_are_the_ones_the_cells_had(geometry, tmp_path):
    """The reference's grid, as the driver passes it, and the port's: the
    file equals the one written with the header the harness always gave."""
    ref = rgrid.create_grid(rconfig.GridParameters(geometry=geometry, vars=VARS,
                                                   **GRIDS[geometry]),
                            torch.float64, "cpu")
    for grid in (ref, port_grid(geometry)):
        phys = np.random.default_rng(6).standard_normal((len(VARS),) + grid.spatial_shape)
        coords = ["r", "l"] + (["z"] if grid.geometry == "RLZ" else [])
        cols = np.concatenate([grid.gridpoints()] + [p.reshape(-1, 1) for p in phys], axis=1)
        np.savetxt(tmp_path / "before.csv", cols, delimiter=",", fmt="%.17g", comments="",
                   header=",".join(coords + list(grid.params.vars)))
        harness.write_ics(tmp_path / "now.csv", grid, phys)
        assert (tmp_path / "now.csv").read_bytes() == (tmp_path / "before.csv").read_bytes()


def test_a_geometry_outside_the_table_is_refused(tmp_path):
    def stub(geometry, ndims):
        return types.SimpleNamespace(
            geometry=geometry, gridpoints=lambda: np.zeros((4, ndims)),
            params=types.SimpleNamespace(vars=("a",)))

    with pytest.raises(ValueError, match="'XZ'"):
        harness.write_ics(tmp_path / "x.csv", stub("XZ", 2), np.zeros((1, 4)))
    with pytest.raises(ValueError, match="3 coordinates"):
        harness.write_ics(tmp_path / "x.csv", stub("RL", 3), np.zeros((1, 4)))
    assert not (tmp_path / "x.csv").exists()
