"""Skamarock & Klemp (1994) inertia-gravity wave test on the RZ grid, in
PyTorch: the port of ``examples/inertia_gravity_wave.py``.

A 0.01 K potential-temperature anomaly with vertical structure
sin(pi z / H) in a uniformly stratified channel (N = 0.01 1/s, rigid
lids, periodic in x) is advected by a 20 m/s mean flow while radiating
dispersive gravity waves.  The linear Boussinesq solution is analytic
(each horizontal wavenumber k of the m = pi/H mode oscillates at the
intrinsic frequency omega = N k / sqrt(k^2 + m^2), Doppler-shifted by U)
[Skamarock & Klemp, MWR 122, 1994].  Here it runs as Euler_test
(compressible, perturbation form, semi-implicit vertical acoustics) with
periodic radial B-splines: 150 cells x 24 levels, ts 0.75 s, 3000 s =
4,000 steps, one column solve of 450 x 24 columns a step.  The JAX
package's f64 runs read a correlation of 0.86-0.87 against the analytic
field, the compressible-against-Boussinesq difference.

Run:  python -m scythe_tpu_torch.examples.inertia_gravity_wave [--cpu]
      [--cells 150] [--nz 24] [--ts 0.75] [--time 3000] [--dir DIR]
Float64 on the card as on the CPU (the JAX example's float32 default on a
TPU is not kept): the 0.01 K anomaly is 3e-5 of theta, and in float32 the
rounding of the transforms' radial sums drifts the wave off its bands in
both packages (correlation 0.70 in the port on the card and the CPU, 0.845
in JAX; tools/torch_igw_f32_check.py).
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
from .straka_density_current import ref_columns, snapshots

N_BV = 0.01  # Brunt-Vaisala frequency [1/s]
H = 10000.0  # channel depth [m]
LX = 300000.0  # channel length [m]
U_MEAN = 20.0  # mean flow [m/s]
A_WIDTH = 5000.0  # anomaly half-width [m]
X_C = 100000.0  # anomaly center [m]
DTHETA = 0.01  # anomaly amplitude [K]


def build_model(out_dir, num_cells=150, nz=24, ts=0.75, t_end=3000.0):
    os.makedirs(out_dir, exist_ok=True)
    sounding = os.path.join(out_dir, "sounding.txt")
    zs = np.linspace(0.0, 1.2 * H, 60)
    theta = 300.0 * np.exp(N_BV**2 * zs / 9.81)
    with open(sounding, "w") as f:
        f.write(f"1000.0 {theta[0]} 0.0\n")
        for z, th in zip(zs[1:], theta[1:]):
            f.write(f"{z} {th} 0.0\n")

    names = ("s", "xi", "mu", "u", "w")
    gp = GridParameters(
        geometry="RZ",
        xmin=0.0,
        xmax=LX,
        num_cells=num_cells,
        zmin=0.0,
        zmax=H,
        zDim=nz,
        BCL={n: BC.PERIODIC for n in names},
        BCR={n: BC.PERIODIC for n in names},
        # rigid free-slip lids; theta' (and hence s') = 0 there by the
        # sin(pi z/H) structure of the anomaly
        BCB={"s": ZBC.R1T0, "u": ZBC.R1T1, "w": ZBC.R1T0},
        BCT={"s": ZBC.R1T0, "u": ZBC.R1T1, "w": ZBC.R1T0},
        vars={n: i + 1 for i, n in enumerate(names)},
    )
    return ModelParameters(
        ts=ts,
        integration_time=t_end,
        output_interval=t_end,
        equation_set="Euler_test",
        initial_conditions=os.path.join(out_dir, "ics.csv"),
        output_dir=out_dir,
        ref_state_file=sounding,
        grid_params=gp,
        physical_params={"K": 0.0},
        options={"semiimplicit": True},
    )


def base_state(ref_state):
    """(sbar, xibar, mubar, rho_bar, T_bar, theta_bar) columns, float64
    numpy [nz]."""
    sbar0, xibar0, mubar0 = ref_columns(ref_state)
    _, rho_bar, T_bar, _ = td.on_host(td.thermodynamic_tuple, sbar0, xibar0, mubar0)
    theta_bar = td.on_host(td.potential_temperature, sbar0, xibar0, mubar0)
    return sbar0, xibar0, mubar0, rho_bar, T_bar, theta_bar


def write_ics(model, grid, ref_state):
    """theta' anomaly at constant pressure riding a uniform U_MEAN flow."""
    sbar0, _, _, rho_bar, T_bar, theta_bar = base_state(ref_state)
    pts = grid.gridpoints()
    x = pts[:, 0].reshape(grid.spatial_shape)
    z = pts[:, 1].reshape(grid.spatial_shape)
    thp0 = DTHETA * np.sin(np.pi * z / H) / (1.0 + ((x - X_C) / A_WIDTH) ** 2)
    T_new = T_bar[None, :] * (1.0 + thp0 / theta_bar[None, :])
    rho_new = rho_bar[None, :] * T_bar[None, :] / T_new
    s_pert = td.on_host(td.entropy, T_new, rho_new, 0.0) - sbar0[None, :]
    xi_pert = np.log(T_bar[None, :] / T_new)
    n = x.size
    _write_csv(model.initial_conditions, ["r", "z", "s", "xi", "mu", "u", "w"],
               np.stack([x.ravel(), z.ravel(), s_pert.ravel(), xi_pert.ravel(),
                         np.zeros(n), np.full(n, U_MEAN), np.zeros(n)], axis=1))


def theta_pert(phys, grid, ref_state):
    sbar0, xibar0, mubar0, _, _, theta_bar = base_state(ref_state)
    s = np.asarray(phys[0], np.float64).reshape(grid.spatial_shape)
    xi = np.asarray(phys[1], np.float64).reshape(grid.spatial_shape)
    th = td.on_host(td.potential_temperature, s + sbar0[None, :], xi + xibar0[None, :],
                    mubar0[None, :])
    return th - theta_bar[None, :]


def analytic_theta_pert(grid, t_end, nx_f=4096):
    """Linear Boussinesq solution evaluated at the grid points: the
    m = pi/H vertical mode, each k at cos(omega t) with the Doppler
    shift exp(-i k U t)."""
    xf = np.linspace(0.0, LX, nx_f, endpoint=False)
    fh = np.fft.rfft(DTHETA / (1.0 + ((xf - X_C) / A_WIDTH) ** 2))
    k = 2.0 * np.pi * np.fft.rfftfreq(nx_f, d=LX / nx_f)
    m = np.pi / H
    omega = N_BV * k / np.sqrt(k**2 + m**2)
    f_t = np.fft.irfft(fh * np.cos(omega * t_end) * np.exp(-1j * k * U_MEAN * t_end), n=nx_f)
    fx = np.interp(grid.r_mish, xf, f_t, period=LX)
    return fx[:, None] * np.sin(np.pi * np.asarray(grid.z_mish)[None, :] / H)


def energy_centroid_x(thp, grid):
    """Circular centroid of theta'^2 along x (tracks the U t drift)."""
    w = (thp**2).sum(axis=1)
    ang = 2.0 * np.pi * grid.r_mish / LX
    c = (w * np.cos(ang)).sum()
    s = (w * np.sin(ang)).sum()
    return (np.arctan2(s, c) % (2.0 * np.pi)) * LX / (2.0 * np.pi)


def correlation(thp, th_an):
    """The model's theta' against the analytic field, uncentred."""
    return float((thp * th_an).sum() / np.sqrt((thp**2).sum() * (th_an**2).sum()))


def readings(grid, ref_state, phys, t_end):
    """The test's numbers of final fields: the correlation with the analytic
    field, the model's and the analytic theta' extrema, both energy
    centroids (m) and the mean flow's mean and largest departure (m/s)."""
    thp = theta_pert(phys, grid, ref_state)
    th_an = analytic_theta_pert(grid, t_end)
    u = np.asarray(phys[3]).reshape(grid.spatial_shape)
    return {"corr": correlation(thp, th_an),
            "theta_max": float(thp.max()), "theta_min": float(thp.min()),
            "analytic_max": float(th_an.max()), "analytic_min": float(th_an.min()),
            "centroid_m": float(energy_centroid_x(thp, grid)),
            "analytic_centroid_m": float(energy_centroid_x(th_an, grid)),
            "u_mean": float(u.mean()), "u_dev_max": float(np.abs(u - U_MEAN).max())}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    ap.add_argument("--cells", type=int, default=150)
    ap.add_argument("--nz", type=int, default=24)
    ap.add_argument("--ts", type=float, default=0.75)
    ap.add_argument("--time", type=float, default=3000.0)
    ap.add_argument("--dir", default="./igw_out")
    args = ap.parse_args(argv)
    from ..model import build_context

    model = build_model(args.dir, args.cells, args.nz, args.ts, args.time)
    grid = create_grid(model.grid_params, torch.float64, device="cpu")  # the ICs
    write_ics(model, grid, build_context(model, grid, torch.float64).ref_state)
    grid, ctx, runs = snapshots(model, 1, torch.float64, "cpu" if args.cpu else DEFAULT)
    r = readings(grid, ctx.ref_state, runs[-1][1], args.time)
    print(
        f"t = {args.time:.0f} s: corr vs linear Boussinesq analytic = {r['corr']:.3f}, "
        f"theta' range model ({r['theta_min']:.2e}, {r['theta_max']:.2e}) vs analytic "
        f"({r['analytic_min']:.2e}, {r['analytic_max']:.2e}), energy centroid "
        f"{r['centroid_m']/1e3:.1f} km (analytic {r['analytic_centroid_m']/1e3:.1f} km)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
