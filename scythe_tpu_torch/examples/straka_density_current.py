"""Straka et al. (1993) density-current benchmark on the RZ grid, in
PyTorch: the port of ``examples/straka_density_current.py``.

A -15 K cold bubble collapses in a neutrally stratified (theta = 300 K)
dry atmosphere with fixed viscosity K = 75 m^2/s; the cold pool spreads
along the ground as a density current with Kelvin-Helmholtz rotors.  The
converged reference solution (25 m grid) puts the front (the surface
theta' = -1 K point) at 15,537 m and theta'_min at -9.77 K at t = 900 s
[Straka, Wilhelmson, Wicker, Anderson & Droegemeier, IJNMF 17, 1993].

Euler_test perturbation dynamics with the semi-implicit vertical solve;
the RZ grid's radial coordinate is a Cartesian x here (no curvature terms
in Euler_test), so the domain is the full [-25.6, 25.6] km strip.  The
published run: 128 cells x 48 levels, ts 0.125 s, 900 s = 7,200 steps, one
column solve of 384 x 48 columns a step.

Run:  python -m scythe_tpu_torch.examples.straka_density_current [--cpu]
      [--cells 128] [--nz 48] [--ts 0.125] [--time 900] [--dir DIR]
(float32 on the card, float64 with --cpu.)
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import BC, ZBC, GridParameters, ModelParameters, create_grid
from ..device import DEFAULT
from ..io import _write_csv
from ..physics import thermodynamics as td


def ref_columns(ref_state):
    """(sbar, xibar, mubar) of the reference state's columns as float64
    numpy [nz]."""
    return tuple(np.asarray(a[:, 0].detach().cpu(), np.float64)
                 for a in (ref_state.sbar, ref_state.xibar, ref_state.mubar))


def build_model(out_dir, num_cells=128, nz=48, ts=0.125, t_end=900.0):
    """ModelParameters for the Straka case (sounding + grid + physics)."""
    os.makedirs(out_dir, exist_ok=True)
    sounding = os.path.join(out_dir, "sounding.txt")
    with open(sounding, "w") as f:
        # isentropic dry atmosphere: theta = 300 K, p_sfc = 1000 hPa
        f.write("1000.0 300.0 0.0\n")
        for z in np.linspace(200.0, 8000.0, 40):
            f.write(f"{z} 300.0 0.0\n")

    gp = GridParameters(
        geometry="RZ",
        xmin=-25600.0,
        xmax=25600.0,
        num_cells=num_cells,
        zmin=0.0,
        zmax=6400.0,
        zDim=nz,
        BCL={"u": BC.R1T0, "w": BC.R1T1},
        BCR={"u": BC.R1T0, "w": BC.R1T1},
        # free-slip, insulated walls: u_z = 0, s_z = 0, w = 0 at top and
        # bottom (an unconstrained s fit lets K s_zz pump entropy through
        # the boundary)
        BCB={"s": ZBC.R1T1, "u": ZBC.R1T1, "mu": ZBC.R1T1, "w": ZBC.R1T0},
        BCT={"s": ZBC.R1T1, "u": ZBC.R1T1, "mu": ZBC.R1T1, "w": ZBC.R1T0},
        vars={"s": 1, "xi": 2, "mu": 3, "u": 4, "w": 5},
    )
    return ModelParameters(
        ts=ts,
        integration_time=t_end,
        output_interval=t_end / 3.0,
        equation_set="Euler_test",
        initial_conditions=os.path.join(out_dir, "ics.csv"),
        output_dir=out_dir,
        ref_state_file=sounding,
        grid_params=gp,
        physical_params={"K": 75.0},
        options={"semiimplicit": True},
    )


def write_ics(model, grid, ref_state):
    """Cold bubble as perturbation (s', xi') fields at constant pressure:
    a temperature perturbation dT at unchanged pressure (Straka's
    specification), so T_new = Tbar + dT, rho_new = rhobar Tbar / T_new,
    xi' = ln(Tbar / T_new), s' = entropy(T_new, rho_new, 0) - sbar."""
    sbar0, xibar0, mubar0 = ref_columns(ref_state)
    _, rho_bar, T_bar, _ = td.on_host(td.thermodynamic_tuple, sbar0, xibar0, mubar0)

    pts = grid.gridpoints()
    x = pts[:, 0].reshape(grid.spatial_shape)
    z = pts[:, 1].reshape(grid.spatial_shape)
    L = np.sqrt((x / 4000.0) ** 2 + ((z - 3000.0) / 2000.0) ** 2)
    dT = np.where(L <= 1.0, -15.0 * (np.cos(np.pi * L) + 1.0) / 2.0, 0.0)

    T_new = T_bar[None, :] + dT
    rho_new = rho_bar[None, :] * T_bar[None, :] / T_new
    s_pert = td.on_host(td.entropy, T_new, rho_new, 0.0) - sbar0[None, :]
    xi_pert = np.log(T_bar[None, :] / T_new)
    zero = np.zeros(x.size)
    _write_csv(model.initial_conditions, ["r", "z", "s", "xi", "mu", "u", "w"],
               np.stack([x.ravel(), z.ravel(), s_pert.ravel(), xi_pert.ravel(),
                         zero, zero, zero], axis=1))


def theta_pert(phys, grid, ref_state):
    """theta' [x, z] from the perturbation state."""
    sbar0, xibar0, mubar0 = (c[None, :] for c in ref_columns(ref_state))
    s = np.asarray(phys[0], np.float64).reshape(grid.spatial_shape)
    xi = np.asarray(phys[1], np.float64).reshape(grid.spatial_shape)
    th = td.on_host(td.potential_temperature, s + sbar0, xi + xibar0, mubar0)
    return th - td.on_host(td.potential_temperature, sbar0, xibar0, mubar0)


def front_location(thp, grid, zmax_probe=500.0, thresh=-1.0):
    """Max |x| where theta' < thresh in the lowest ``zmax_probe`` meters
    (the Straka front diagnostic)."""
    zsel = np.asarray(grid.z_mish) <= zmax_probe
    x = grid.r_mish
    cold = (thp[:, zsel] < thresh).any(axis=1)
    return float(np.abs(x[cold]).max()) if cold.any() else 0.0


def snapshots(model, n_chunks=1, dtype=None, device=DEFAULT):
    """The run of ``model`` from its IC file on ``device`` (the card unless
    the caller asks for the CPU) in ``n_chunks`` equal parts, through
    model.initialize and build_step.  Returns (grid, ctx, [(t, fields
    [nvars, *spatial] as float64 numpy)]) from t = 0; raises
    FloatingPointError on a non-finite state."""
    from ..model import build_step, initialize, make_scan

    dtype = dtype or torch.get_default_dtype()
    grid, ctx, state = initialize(model, dtype, device)
    scan = make_scan(build_step(model, grid, ctx, dtype), model.num_ts // n_chunks)
    out = []
    for k in range(n_chunks + 1):
        if k:
            state = scan(state)
        phys = grid.synthesis(state.spec)["val"].cpu().numpy().astype(np.float64)
        if not np.isfinite(phys).all():
            raise FloatingPointError(f"non-finite state at step {state.t - 1}")
        out.append(((state.t - 1) * model.ts, phys))
    return grid, ctx, out


def readings(grid, ref_state, runs):
    """The benchmark's numbers from ``snapshots``' runs (the last at t_end):
    the front and theta'_min at each time, the height of the minimum, and
    the front speed over the last part."""
    fronts, thmin = [], []
    for _, phys in runs[1:]:
        thp = theta_pert(phys, grid, ref_state)
        fronts.append(front_location(thp, grid))
        thmin.append(float(thp.min()))
    _, jmin = np.unravel_index(np.argmin(thp), thp.shape)
    dt = runs[-1][0] - runs[-2][0]
    return {"t": [t for t, _ in runs[1:]], "front_m": fronts, "theta_min_K": thmin,
            "z_of_min_m": float(grid.z_mish[jmin]),
            "front_speed_m_s": (fronts[-1] - fronts[-2]) / dt if len(fronts) > 1 else None}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    ap.add_argument("--cells", type=int, default=128)
    ap.add_argument("--nz", type=int, default=48)
    ap.add_argument("--ts", type=float, default=0.125)
    ap.add_argument("--time", type=float, default=900.0)
    ap.add_argument("--dir", default="./straka_out")
    args = ap.parse_args(argv)
    from ..model import build_context

    model = build_model(args.dir, args.cells, args.nz, args.ts, args.time)
    grid = create_grid(model.grid_params, torch.float64, device="cpu")  # the ICs
    write_ics(model, grid, build_context(model, grid, torch.float64).ref_state)
    grid, ctx, runs = snapshots(model, 3, torch.float64 if args.cpu else torch.float32,
                                "cpu" if args.cpu else DEFAULT)
    r = readings(grid, ctx.ref_state, runs)
    print(
        f"t = {args.time:.0f} s: theta'_min = {r['theta_min_K'][-1]:.2f} K "
        f"(converged ref -9.77), front = {r['front_m'][-1]:.0f} m "
        f"(converged ref 15537; coarse-grid band ~14-17 km)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
