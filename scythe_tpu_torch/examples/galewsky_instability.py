"""Galewsky et al. (2004) barotropic-instability test on the SL sphere, in
PyTorch: the port of ``examples/galewsky_instability.py``.

The standard nonlinear global shallow-water benchmark: a balanced
mid-latitude jet (u_max = 80 m/s between 25.7N and 64.3N) seeded with a
small height bump rolls up into a vortex train by day ~5 through
barotropic instability.  The JAX package's f64 run (128 lat cells ~ 0.47
deg x 512 lon, K = 2e4 m^2/s) read, day by day:

    day:        1     2     3     4      5       6
    dev energy: 6.0   7.3   9.7   90   875    3899   [m^2, zonal-dev h]
    u_max:      78.0  76.3  75.1  75.1  74.7   74.1

exponential growth at ~e^2/day from day 3 with the jet amplitude kept to
a few percent.  At 64 cells the spline filter erodes the jet faster than
the instability grows: the test needs the ~0.5 deg resolution its authors
prescribe.  Float64 throughout (the growth rate is the quantity of
interest); ShallowWaterSphere, 128 x 512, ts 34 s from the pole-ring
gravity CFL, 2,541 steps a day.  The run steps in a plain loop a day at a
time (the JAX example's chunked scan caps XLA's compile time).

Run:  python -m scythe_tpu_torch.examples.galewsky_instability [--cpu]
      [--cells 128] [--days 6]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import GridParameters, ModelParameters, create_grid
from ..device import DEFAULT

A_EARTH = 6.37122e6
OMEGA = 7.292e-5
G = 9.80616
PHI0, PHI1 = np.pi / 7, np.pi / 2 - np.pi / 7
UMAX = 80.0
_EN = np.exp(-4.0 / (PHI1 - PHI0) ** 2)
# the JAX example's day-by-day readings at 128 cells, f64 (its docstring):
# (zonal-deviation energy m^2, u_max m/s)
REFERENCE = {1: (6.0, 78.0), 2: (7.3, 76.3), 3: (9.7, 75.1), 4: (90.0, 75.1),
             5: (875.0, 74.7), 6: (3899.0, 74.1)}


def u_jet(phi):
    inside = (phi > PHI0) & (phi < PHI1)
    with np.errstate(divide="ignore", over="ignore"):
        val = UMAX / _EN * np.exp(
            1.0 / np.where(inside, (phi - PHI0) * (phi - PHI1), -1.0)
        )
    return np.where(inside, val, 0.0)


def balanced_height(phi, h_mean=10000.0, n_quad=20001):
    """gh from gradient-wind balance of the jet (fine-grid quadrature)."""
    pf = np.linspace(-np.pi / 2, np.pi / 2, n_quad)
    uj = u_jet(pf)
    integ = A_EARTH * uj * (2 * OMEGA * np.sin(pf) + np.tan(pf) * uj / A_EARTH)
    gh = -np.concatenate(
        [[0.0], np.cumsum(0.5 * (integ[1:] + integ[:-1]) * np.diff(pf))]
    )
    gh = gh - gh.mean() + G * h_mean
    return np.interp(phi, pf, gh) / G


def bump(phi, lam, amp=120.0):
    lamc = lam - np.pi
    return (
        amp
        * np.cos(phi)
        * np.exp(-((lamc / (1.0 / 3.0)) ** 2))
        * np.exp(-((((np.pi / 4) - phi) / (1.0 / 15.0)) ** 2))
    )


def build_model(cells=128, days=6):
    """The example's ModelParameters: the SL grid of ``cells`` latitude cells
    and 4 ``cells`` longitudes, ts from the pole-ring gravity-wave CFL (the
    williamson_sphere rule), output once a day."""
    gp = GridParameters(
        geometry="SL",
        xmin=-np.pi / 2,
        xmax=np.pi / 2,
        num_cells=cells,
        lDim=4 * cells,
        sphere_radius=A_EARTH,
        vars={"h": 1, "u": 2, "v": 3},
    )
    cos_inner = np.sin(0.1127 * np.pi / cells)
    ts = round(0.6 * A_EARTH * cos_inner / np.sqrt(G * 10000.0))
    return ModelParameters(
        ts=float(ts),
        integration_time=days * 86400.0,
        output_interval=86400.0,
        equation_set="ShallowWaterSphere",
        initial_conditions="unused",
        output_dir="./galewsky_out",
        grid_params=gp,
        physical_params={"g": G, "Omega": OMEGA, "K": 2.0e4},
    )


def initial_fields(grid) -> np.ndarray:
    """[h, u, v] on the grid: the balanced jet plus the height bump."""
    pts = grid.gridpoints()
    phi = pts[:, 0].reshape(grid.spatial_shape)
    lam = pts[:, 1].reshape(grid.spatial_shape)
    return np.stack([balanced_height(phi) + bump(phi, lam), u_jet(phi),
                     np.zeros_like(phi)])


def day_readings(out) -> tuple[float, float, bool]:
    """(zonal-deviation energy of h m^2, u_max m/s, all finite) of fields
    [3, *spatial] (numpy)."""
    dev = out[0] - out[0].mean(axis=1, keepdims=True)
    return float((dev**2).mean()), float(out[1].max()), bool(np.isfinite(out).all())


def run_days(model, days, device=DEFAULT):
    """``days`` days of the model in float64 on ``device`` (the card unless
    the caller asks for the CPU) from ``initial_fields``; yields (day, final
    fields of that day as numpy)."""
    from .. import timeintegration as ti
    from ..model import build_context, build_step, make_scan

    dtype = torch.float64
    grid = create_grid(model.grid_params, dtype, device=device)
    ctx = build_context(model, grid, dtype)
    phys0 = initial_fields(grid)
    state = ti.initial_state(grid.analysis(torch.as_tensor(phys0, dtype=dtype,
                                                           device=grid.device)),
                             phys0.shape, dtype)
    day = make_scan(build_step(model, grid, ctx, dtype), int(round(86400.0 / model.ts)))
    for d in range(1, days + 1):
        state = day(state)
        yield d, grid.synthesis(state.spec)["val"].cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    ap.add_argument("--cells", type=int, default=128)
    ap.add_argument("--days", type=int, default=6)
    args = ap.parse_args(argv)
    model = build_model(args.cells, args.days)
    for d, out in run_days(model, args.days, "cpu" if args.cpu else DEFAULT):
        energy, u_max, finite = day_readings(out)
        print(f"day {d}: zonal-dev energy {energy:9.2f} m^2, u_max {u_max:5.1f} m/s, "
              f"finite={finite}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
