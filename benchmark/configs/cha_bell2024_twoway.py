"""Inputs of ``cha_bell2024_twoway``: Cha & Bell's published initialization
(``scythe_tpu_torch/examples/cha_bell_initialization.py``, after their
notebook): a Rankine vortex in gradient-wind balance, the 3-h symmetric
spin-up of the one-way model, then the elliptical wavenumber-2
perturbation, with the wave's orientation and amplitude drawn from the seed.
The spin-up runs the plain reference in float64 on ``device``: both sides
get the same inputs, and nothing of the program makes them.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import config as rconfig
from benchmark.reference import grid as rgrid
from benchmark.reference import stepper as rstep


def rankine(r, vm, rm):
    return np.where(r < rm, vm * r / rm, vm * rm / r)


def balanced_height(r_points, v_points, f_cor, g):
    """Cumulative gradient-wind balance integration along unique radii
    (the notebook's running integral)."""
    dhdr = (f_cor * v_points + v_points**2 / r_points) / g
    r_unique, idx = np.unique(r_points, return_inverse=True)
    dh_u = np.zeros_like(r_unique)
    for i in range(len(r_unique)):
        dh_u[i] = dhdr[idx == i].mean()
    h_u = np.concatenate([[0.0], np.cumsum(0.5 * (dh_u[1:] + dh_u[:-1]) * np.diff(r_unique))])
    h_u += dh_u[0] * r_unique[0]
    return h_u[idx]


def rankine_fields(cfg, grid) -> np.ndarray:
    """[6, rDim, nl]: h in balance, the free and boundary layers' tangential
    winds the Rankine profile, the rest 0."""
    ic, phys = cfg["ics"], cfg["model"]["physical_params"]
    pts = grid.gridpoints()
    r = pts[:, 0]
    v = rankine(r, ic["vm"], ic["rm"])
    h = balanced_height(r, v, phys["f"], phys["g"])
    out = np.zeros((grid.nvars,) + grid.spatial_shape)
    out[0] = h.reshape(grid.spatial_shape)
    out[2] = out[4] = v.reshape(grid.spatial_shape)
    return out


def spin_up(cfg, phys0, device) -> np.ndarray:
    """The fields after ``ics.spinup`` (the one-way model, its own K) from
    ``phys0``, by the reference in float64."""
    spin = cfg["ics"]["spinup"]
    scfg = json.loads(json.dumps(cfg))
    scfg["model"]["equation_set"] = spin["equation_set"]
    scfg["model"]["physical_params"].update(spin["physical_params"])
    n = int(round(spin["seconds"] / scfg["model"]["ts"]))
    m = harness.model_parameters(rconfig, scfg, out_dir="", ic_path="", ref_state_file="",
                                 n_steps=n, out_steps=n)
    f64 = torch.float64
    grid = rgrid.create_grid(m.grid_params, f64, device)
    ctx = rstep.build_context(m, grid, f64)
    step = rstep.build_step(m, grid, ctx, f64)
    state = rstep.run(step, rstep.initialize(m, grid, ctx, phys0, f64), n)
    return grid.synthesis(state.spec)["val"].cpu().numpy()


def add_wave2(cfg, grid, phys, rng) -> np.ndarray:
    """The elliptical wavenumber-2 vorticity perturbation (the notebook's
    cell 10) on both layers' winds, its axis turned and its ellipticity
    scaled by the seed."""
    ic = cfg["ics"]
    rm, vm = ic["rm"], ic["vm"]
    eps = ic["epsilon"] * (1.0 + ic["perturbation"]["epsilon_frac"] * rng.uniform(-1.0, 1.0))
    phase = rng.uniform(0.0, np.pi)
    pts = grid.gridpoints()
    r = pts[:, 0].reshape(grid.spatial_shape)
    lam = pts[:, 1].reshape(grid.spatial_shape) - phase
    zeta = 2.0 * vm / rm
    inner = r < rm
    vprime = np.where(inner, 0.5 * zeta * r * (eps * np.cos(2 * lam) / rm),
                      0.5 * zeta * (rm**2 / r) * (-eps * np.cos(2 * lam) * rm / r**2))
    uprime = np.where(inner, 0.5 * zeta * r * (eps * np.sin(2 * lam) / rm),
                      0.5 * zeta * (rm**2 / r) * (eps * np.sin(2 * lam) * rm / r**2))
    out = phys.copy()
    for i in (1, 3):  # u, ub
        out[i] = out[i] + uprime
    for i in (2, 4):  # v, vb
        out[i] = out[i] + vprime
    return out


def make_inputs(cfg, grid, run_dir, rng, device):
    """(phys0, ref_state_file) on the reference's float64 CPU ``grid``; the
    slab model has no sounding."""
    spun = spin_up(cfg, rankine_fields(cfg, grid), device)
    return add_wave2(cfg, grid, spun, rng), ""
