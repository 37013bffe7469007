"""Cha & Bell (2024) two-layer TC initialization workflow, in PyTorch: the
port of ``examples/cha_bell_initialization.py`` with the model files of
``models/cha_bell2024/`` (ref notebooks/Cha_Bell_WCD2024_initialization.ipynb).

Stages:
  1. build Rankine-vortex initial conditions in gradient-wind balance,
  2. run the 3 h symmetric spinup (Oneway_ShallowWater_Slab),
  3. read the spun-up output, add the elliptical wavenumber-2 perturbation,
  4. write the wave-2 ICs for the 24 h one-way / two-way runs
     (``oneway_model`` / ``twoway_model``).

Run:  python -m scythe_tpu_torch.examples.cha_bell_initialization [--quick]
      [--cpu] [--dir DIR]
(--quick shrinks the spinup to 10 min of model time; the run is on the card
unless --cpu is given.)  Then, for the two-way experiment:

    import torch, scythe_tpu_torch as tx
    from scythe_tpu_torch.examples.cha_bell_initialization import twoway_model
    grid, phys = tx.integrate_model(twoway_model(DIR), dtype=torch.float32,
                                    device="cuda")

``flagship_model``, ``vortex_phys`` and ``vortex_state`` are the small
programmatic configuration of the same two-way model that the golden
trajectory (tests/golden/twoway_slab_50steps_f64.npz) was made from.
"""

from __future__ import annotations

import argparse
import os
from typing import Any

import numpy as np
import torch

from .. import BC, GridParameters, ModelParameters, create_grid, integrate_model
from .. import io as sio
from .. import timeintegration as ti
from ..device import DEFAULT

RMAX = 50000.0
VMAX = 50.0
F_COR = 5.0e-5
EPSILON = 5000.0
G = 9.81

IC_COLUMNS = ["r", "l", "h", "u", "v", "ub", "vb", "wb"]

PHYSICS = {
    "g": 9.81,
    "K": 5000.0,
    "Cd": 2.4e-3,
    "Hfree": 2000.0,
    "Hb": 1000.0,
    "f": 5.0e-5,
}


def cha_bell_grid(num_cells: int = 100, lDim: int = 256) -> GridParameters:
    """The shared grid of the two-layer models (models/cha_bell2024/common.py:
    100 cells over 300 km, 256 uniform azimuthal points)."""
    return GridParameters(
        geometry="RL",
        xmin=0.0,
        xmax=3.0e5,
        num_cells=num_cells,
        lDim=lDim,
        BCL={
            "h": BC.R1T1,
            "u": BC.R1T0,
            "v": BC.R1T0,
            "ub": BC.R1T0,
            "vb": BC.R1T0,
            "wb": BC.R1T1,
        },
        BCR={
            "h": BC.R0,
            "u": BC.R1T1,
            "v": BC.R0,
            "ub": BC.R1T1,
            "vb": BC.R0,
            "wb": BC.R0,
        },
        vars={"h": 1, "u": 2, "v": 3, "ub": 4, "vb": 5, "wb": 6},
    )


def spinup_model(base_dir: str = ".", grid_params: GridParameters | None = None):
    """3-hour symmetric spinup of the one-way model
    (models/cha_bell2024/oneway_spinup.py)."""
    out = os.path.join(base_dir, "Oneway_SWslab_spinup")
    return ModelParameters(
        ts=3.0,
        integration_time=10800.0,
        output_interval=3600.0,
        equation_set="Oneway_ShallowWater_Slab",
        initial_conditions=os.path.join(out, "SWslab_OnewayRankine.csv"),
        output_dir=out,
        grid_params=grid_params or cha_bell_grid(),
        physical_params={**PHYSICS, "K": 3000.0},
    )


def oneway_model(base_dir: str = ".", grid_params: GridParameters | None = None):
    """24-hour one-way wavenumber-2 run (models/cha_bell2024/oneway.py)."""
    out = os.path.join(base_dir, "Oneway_SWslab_wave2")
    return ModelParameters(
        ts=3.0,
        integration_time=86400.0,
        output_interval=120.0,
        equation_set="Oneway_ShallowWater_Slab",
        initial_conditions=os.path.join(out, "SWslab_wave2.csv"),
        output_dir=out,
        grid_params=grid_params or cha_bell_grid(),
        physical_params=PHYSICS,
    )


def twoway_model(base_dir: str = ".", grid_params: GridParameters | None = None):
    """24-hour two-way (mass sink/source feedback) wavenumber-2 run
    (models/cha_bell2024/twoway.py)."""
    out = os.path.join(base_dir, "Twoway_SWslab_wave2")
    return ModelParameters(
        ts=3.0,
        integration_time=86400.0,
        output_interval=120.0,
        equation_set="Twoway_ShallowWater_Slab",
        initial_conditions=os.path.join(out, "SWslab_wave2.csv"),
        output_dir=out,
        grid_params=grid_params or cha_bell_grid(),
        physical_params={**PHYSICS, "S1": 1.0e-5},
    )


def rankine_profile(r):
    v0 = VMAX / RMAX
    return np.where(r < RMAX, v0 * r, RMAX * RMAX * v0 / r)


def balanced_height(r_points, v_points):
    """Cumulative gradient-wind balance integration along unique radii
    (ref notebook cell 5's running integral)."""
    dhdr = (F_COR * v_points + v_points**2 / r_points) / G
    r_unique, idx = np.unique(r_points, return_inverse=True)
    dh_u = np.zeros_like(r_unique)
    for i, ru in enumerate(r_unique):
        dh_u[i] = dhdr[idx == i].mean()
    h_u = np.concatenate([[0.0], np.cumsum(0.5 * (dh_u[1:] + dh_u[:-1]) * np.diff(r_unique))])
    h_u += dh_u[0] * r_unique[0]
    return h_u[idx]


def write_rankine_ics(grid, path):
    pts = grid.gridpoints()
    r, lam = pts[:, 0], pts[:, 1]
    v = rankine_profile(r)
    h = balanced_height(r, v)
    zero = np.zeros_like(r)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    sio._write_csv(path, IC_COLUMNS, np.stack([r, lam, h, zero, v, zero, v, zero], axis=1))


def add_wave2(grid, balanced_csv, out_path):
    """Wavenumber-2 elliptical vorticity perturbation on the spun-up state
    (ref notebook cell 10)."""
    names, data = sio._read_csv(balanced_csv)
    col = {n: data[:, i] for i, n in enumerate(names)}
    r, lam = col["r"], col["l"]
    zeta = 2.0 * VMAX / RMAX
    inner = r < RMAX
    vprime = np.where(
        inner,
        0.5 * zeta * r * (EPSILON * np.cos(2 * lam) / RMAX),
        0.5 * zeta * (RMAX**2 / r) * (-EPSILON * np.cos(2 * lam) * RMAX / r**2),
    )
    uprime = np.where(
        inner,
        0.5 * zeta * r * (EPSILON * np.sin(2 * lam) / RMAX),
        0.5 * zeta * (RMAX**2 / r) * (EPSILON * np.sin(2 * lam) * RMAX / r**2),
    )
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    cols = np.stack(
        [r, lam, col["h"], col["u"] + uprime, col["v"] + vprime,
         col["ub"] + uprime, col["vb"] + vprime, col["wb"]],
        axis=1,
    )
    sio._write_csv(out_path, IC_COLUMNS, cols)


def flagship_model(num_cells: int = 32, nl: int = 32) -> ModelParameters:
    """The two-way model at a small programmatic size: ten 3 s steps."""
    return ModelParameters(
        ts=3.0,
        integration_time=30.0,
        output_interval=30.0,
        equation_set="Twoway_ShallowWater_Slab",
        grid_params=cha_bell_grid(num_cells, nl),
        physical_params={**PHYSICS, "S1": 1.0e-5},
    )


def vortex_phys(grid) -> np.ndarray:
    """Rankine vortex + wavenumber-2 perturbation physical fields (the
    Cha & Bell initialization, built programmatically)."""
    pts = grid.gridpoints()
    r = pts[:, 0].reshape(grid.spatial_shape)
    lam = pts[:, 1].reshape(grid.spatial_shape)
    rm, vm = 5.0e4, 20.0
    v = np.where(r < rm, vm * r / rm, vm * rm / r) * (1.0 + 0.05 * np.cos(2 * lam))
    phys = np.zeros((grid.nvars,) + grid.spatial_shape)
    phys[2] = v  # free-layer tangential wind
    phys[4] = 0.8 * v  # boundary-layer tangential wind
    return phys


def vortex_state(grid, dtype) -> ti.ModelState:
    """The initial state of ``vortex_phys`` on the grid's device."""
    phys = torch.as_tensor(vortex_phys(grid), dtype=dtype, device=grid.device)
    return ti.initial_state(
        grid.analysis(phys), (grid.nvars,) + grid.spatial_shape, dtype
    )


def initialize_wave2(base_dir: str = ".", *, quick: bool = False, dtype=None,
                     grid_params: GridParameters | None = None,
                     device: Any = DEFAULT):
    """Stages 1-4: Rankine ICs, the symmetric spinup (10 min with ``quick``,
    else 3 h) on ``device``, and the wave-2 ICs of ``oneway_model`` and
    ``twoway_model`` under ``base_dir``.  Returns the spinup model."""
    model = spinup_model(base_dir, grid_params)
    if quick:
        model = model.with_(integration_time=600.0, output_interval=600.0)
    grid = create_grid(model.grid_params, torch.float64, device="cpu")  # points only
    write_rankine_ics(grid, model.initial_conditions)
    integrate_model(model, dtype=dtype, device=device)
    t_final = str(round(model.integration_time, 2))
    balanced = os.path.join(model.output_dir, f"physical_out_{t_final}.csv")
    for wave2 in (oneway_model(base_dir, grid_params), twoway_model(base_dir, grid_params)):
        add_wave2(grid, balanced, wave2.initial_conditions)
    return model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="10-min spinup demo")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    ap.add_argument("--dir", default=".", help="where the run directories go")
    args = ap.parse_args(argv)
    print("Writing Rankine ICs, running the symmetric spinup, adding wavenumber 2 ...")
    initialize_wave2(args.dir, quick=args.quick, device="cpu" if args.cpu else DEFAULT)
    print(
        "Done. The 24 h experiments are oneway_model(DIR) and twoway_model(DIR) "
        "of this module, run with scythe_tpu_torch.integrate_model."
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
