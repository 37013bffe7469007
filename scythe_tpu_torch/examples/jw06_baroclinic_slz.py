"""Jablonowski & Williamson (2006) baroclinic wave on the SLZ shell
(MoistEulerSLZ with trace moisture), in PyTorch: the port of
``examples/jw06_baroclinic_slz.py``.

The analytic JW06 state (their eqs. 2-12: zonal jets in thermal-wind
balance with T(eta, phi) and Phi(eta, phi)) is mapped to height by
inverting Phi(eta, phi) = g z pointwise; the model's reference column is
the phi = 45 deg column (``exact_reference_state``), and the latitude
structure rides in the perturbation fields.  ``--balanced-init`` solves the
model's own discrete gradient-wind / hydrostatic balance for the zonal mean
(``scythe_tpu_torch.balance``) and adds the wind bump on top of it.

    python -m scythe_tpu_torch.examples.jw06_baroclinic_slz [--cpu]
        [--days 9] [--cells 24] [--nl 96] [--zdim 24] [--ts 15] [--steady]

The production recipe (the JAX example's round-5 bundle):

    python -m scythe_tpu_torch.examples.jw06_baroclinic_slz --cells 48 \\
        --nl 96 --zdim 24 --ts 7.5 --days 12 --l-q 0 --balanced-init \\
        --balance-cache --sponge-top-km 12 --k4 6e16 --smag 0.21

``production_model`` builds that configuration.  The balance runs on the
run's device in float64; the run itself in float32 on the card (float64
with ``--cpu``).  ``--balance-cache`` keeps the solved correction in the
output directory under a key of everything that enters the solve (the
grid, the physics, every option, the time step, the reference column, the
zonal-mean state and the solve's own settings), where the JAX example keys
it on (cells, zdim) alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys

import numpy as np
import torch

# JW06 constants (their Table 1)
A_SPH = 6.371229e6
OMEGA = 7.29212e-5
G = 9.80616
RD = 287.04
P0 = 1.0e5  # Pa
U0 = 35.0
T0 = 288.0
GAMMA = 0.005
ETA_T = 0.2
ETA_0 = 0.252
DELTA_T = 4.8e5
Q_TRACE = 0.01  # g/kg trace vapor (exact zero NaNs the f32 moist path)

VARS = {"s": 1, "xi": 2, "mu": 3, "u": 4, "v": 5, "w": 6,
        "mu_c": 7, "mu_r": 8, "qss": 9}


def _f64(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _eta_v(eta):
    return (eta - ETA_0) * np.pi / 2.0


def t_mean(eta):
    t = T0 * eta ** (RD * GAMMA / G)
    return np.where(eta < ETA_T, t + DELTA_T * (ETA_T - eta) ** 5, t)


def phi_mean(eta):
    base = T0 * G / GAMMA * (1.0 - eta ** (RD * GAMMA / G))
    corr = RD * DELTA_T * (
        (np.log(eta / ETA_T) + 137.0 / 60.0) * ETA_T**5
        - 5.0 * ETA_T**4 * eta
        + 5.0 * ETA_T**3 * eta**2
        - (10.0 / 3.0) * ETA_T**2 * eta**3
        + 1.25 * ETA_T * eta**4
        - 0.2 * eta**5
    )
    return np.where(eta < ETA_T, base - corr, base)


def _horiz_factors(phi):
    """The two latitude factors of JW06's T and Phi corrections."""
    sinp, cosp = np.sin(phi), np.cos(phi)
    f1 = -2.0 * sinp**6 * (cosp**2 + 1.0 / 3.0) + 10.0 / 63.0
    f2 = 1.6 * cosp**3 * (sinp**2 + 2.0 / 3.0) - np.pi / 4.0
    return f1, f2


def temperature(eta, phi):
    ev = _eta_v(eta)
    f1, f2 = _horiz_factors(phi)
    corr = (
        0.75 * (eta * np.pi * U0 / RD)
        * np.sin(ev) * np.sqrt(np.abs(np.cos(ev)))
        * (f1 * 2.0 * U0 * np.cos(ev) ** 1.5 + f2 * A_SPH * OMEGA)
    )
    return t_mean(eta) + corr


def geopotential(eta, phi):
    ev = _eta_v(eta)
    f1, f2 = _horiz_factors(phi)
    corr = U0 * np.cos(ev) ** 1.5 * (
        f1 * U0 * np.cos(ev) ** 1.5 + f2 * A_SPH * OMEGA
    )
    return phi_mean(eta) + corr


def u_wind(eta, phi):
    return U0 * np.cos(_eta_v(eta)) ** 1.5 * np.sin(2.0 * phi) ** 2


def eta_of_z(z, phi):
    """Newton inversion of geopotential(eta, phi) = g z (vectorized)."""
    z = np.asarray(z, np.float64)
    eta = np.full(np.broadcast(z, phi).shape, 0.5)
    target = G * z
    for _ in range(60):
        f = geopotential(eta, phi) - target
        df = (geopotential(eta * 1.0001, phi) - f - target) / (eta * 1e-4)
        d = f / df
        d = np.clip(d, -0.2, 0.2)  # keep Newton inside the branch
        eta = np.clip(eta - d, 1e-5, 1.5)
        if np.max(np.abs(d)) < 1e-14:
            break
    return eta


def state_at(z, phi):
    """(T, p, rho_d, u) of the JW06 atmosphere at height z, latitude phi
    (broadcastable arrays)."""
    eta = eta_of_z(z, phi)
    T = temperature(eta, phi)
    p = eta * P0
    qv = Q_TRACE * 1e-3
    e = p * qv / (0.622 + qv)
    rho_d = (p - e) / (RD * T)
    return T, p, rho_d, u_wind(eta, phi)


def write_reference_file(path, gp):
    """The phi = 45 deg JW06 column as the model's exact reference state."""
    from ..basis import chebyshev
    from ..physics import thermodynamics as td

    zops = chebyshev.build_ops(gp.zDim, gp.zmin, gp.zmax, gp.b_zDim)
    T, p, rho_d, _ = state_at(zops.points, np.pi / 4.0)
    qv = Q_TRACE * 1e-3
    s = td.entropy(_f64(T), _f64(rho_d), _f64(qv)).numpy()
    xi = td.log_dry_density(_f64(rho_d)).numpy()
    mu = float(td.bhyp(_f64(qv)))
    with open(path, "w") as f:
        for k, z in enumerate(zops.points):
            f.write(f"{z} {s[k]} {xi[k]} {mu} 0.0\n")
    return path


def build_model(out_dir, num_cells=24, nl=96, zdim=24, ts=15.0,
                t_end=9 * 86400.0, K=1.0e5, filter_tau=0.0,
                filter_axes="rl", filter_order=4, smag=0.0, l_q=2.0,
                sponge_top=0.0, sponge_top_tau=600.0, k4=0.0,
                incremental=True, ivd=False, ivd_no_w=False):
    """The JAX example's ModelParameters (the same options and comments
    there), its reference column written under ``out_dir``: free (R0)
    vertical fits but for w, ``l_q`` the spline penalty, horizontal-only
    constant diffusion (K_v 0), si_scale 1.5, and the optional modal
    filter, Smagorinsky closure (horizontal, or isotropic with implicit
    vertical diffusion), top sponge, del^4 and incremental analysis."""
    from .. import GridParameters, ModelParameters, ZBC

    os.makedirs(out_dir, exist_ok=True)
    gp = GridParameters(
        geometry="SLZ",
        xmin=-np.pi / 2,
        xmax=np.pi / 2,
        num_cells=num_cells,
        lDim=nl,
        sphere_radius=A_SPH,
        zmin=0.0,
        zmax=30.0e3,
        zDim=zdim,
        BCB={"w": ZBC.R1T0},
        BCT={"w": ZBC.R1T0},
        vars=VARS,
        l_q=float(l_q),
    )
    return ModelParameters(
        ts=ts,
        integration_time=t_end,
        output_interval=t_end,
        equation_set="MoistEulerSLZ",
        initial_conditions=os.path.join(out_dir, "ics.csv"),
        output_dir=out_dir,
        ref_state_file=write_reference_file(os.path.join(out_dir, "ref.txt"), gp),
        grid_params=gp,
        physical_params={"K": K, "K_v": 0.0, "Omega": OMEGA},
        options={
            "semiimplicit": True,
            "exact_reference_state": True,
            "stiff_relaxation": "exp",
            "si_scale": 1.5,
            **({"modal_filter_tau": float(filter_tau),
                "modal_filter_axes": filter_axes,
                "modal_filter_order": int(filter_order)}
               if filter_tau > 0.0 else {}),
            **({"smagorinsky": float(smag),
                **({"implicit_vdiff": True,
                    **({"vdiff_exclude": ("xi", "qss", "w")}
                       if ivd_no_w else {})} if ivd
                   else {"smagorinsky_axes": "rl"})}
               if smag > 0.0 else {}),
            **({"sponge_top_width": float(sponge_top),
                "sponge_top_tau": float(sponge_top_tau)}
               if sponge_top > 0.0 else {}),
            **({"hyperdiffusion_k4": float(k4)} if k4 > 0.0 else {}),
            **({"incremental_analysis": True} if incremental else {}),
        },
    )


def production_model(out_dir, t_end=12 * 86400.0, num_cells=48, nl=96, zdim=24):
    """The production recipe (the JAX example's docstring): 48 cells x 96 x
    24, ts 7.5 s, l_q 0, a 12 km top sponge, K4 6e16, Smagorinsky 0.21 on
    the horizontal, incremental closing analysis on."""
    return build_model(out_dir, num_cells=num_cells, nl=nl, zdim=zdim, ts=7.5,
                       t_end=t_end, l_q=0.0, sponge_top=12.0e3, k4=6.0e16, smag=0.21)


def _ref_columns(ref_state):
    return tuple(np.asarray(a[:, 0].cpu(), np.float64)
                 for a in (ref_state.sbar, ref_state.xibar, ref_state.mubar))


def initial_fields(grid, ref_state, perturb=True):
    """Perturbation (against the model's reference column) initial fields,
    [nvars, *spatial] float64 numpy."""
    from ..physics import thermodynamics as td

    pts = grid.gridpoints()
    sh = grid.spatial_shape
    phi = pts[:, 0].reshape(sh)
    lam = pts[:, 1].reshape(sh)
    z = pts[:, 2].reshape(sh)

    T, p, rho_d, u = state_at(z, phi)
    if perturb:
        # JW06 eq. 11-12: Gaussian zonal-wind bump at (20E, 40N)
        lam_c, phi_c = np.pi / 9.0, 2.0 * np.pi / 9.0
        rr = A_SPH * np.arccos(np.clip(
            np.sin(phi_c) * np.sin(phi)
            + np.cos(phi_c) * np.cos(phi) * np.cos(lam - lam_c), -1.0, 1.0))
        u = u + 1.0 * np.exp(-((rr / (A_SPH / 10.0)) ** 2))

    qv = Q_TRACE * 1e-3
    s = td.entropy(_f64(T), _f64(rho_d), _f64(qv)).numpy()
    xi = td.log_dry_density(_f64(rho_d)).numpy()
    sbar, xibar, _ = _ref_columns(ref_state)
    phys = np.zeros((grid.nvars,) + sh)
    phys[0] = s - sbar[None, None, :]
    phys[1] = xi - xibar[None, None, :]
    phys[3] = u
    return phys


def diagnostics(grid, ref_state, phys):
    """(u_max, |v|_max, storm-track ps_min, ps_max, eddy ps_min), ps in hPa
    over 25-75 deg N extended hydrostatically to z = 0; the eddy minimum is
    taken against the zonal-mean ps (the JAX example's readings)."""
    from ..physics import thermodynamics as td

    sh = grid.spatial_shape
    sbar, xibar, mubar = _ref_columns(ref_state)
    s = phys[0].reshape(sh) + sbar[None, None, :]
    xi = phys[1].reshape(sh) + xibar[None, None, :]
    mu = phys[2].reshape(sh) + mubar[None, None, :]
    _, _, Tk, p = (a.numpy() for a in td.thermodynamic_tuple(_f64(s), _f64(xi), _f64(mu)))
    z0 = float(grid.z_mish[0])
    ps = p[..., 0] * np.exp(G * z0 / (RD * Tk[..., 0]))
    lat = np.degrees(np.asarray(grid.r_mish))
    band = (lat > 25.0) & (lat < 75.0)
    ps_eddy = ps - ps.mean(axis=1, keepdims=True)
    return (float(phys[3].max()), float(np.abs(phys[4]).max()),
            float(ps[band].min()), float(ps[band].max()),
            float(ps_eddy[band].min()))


def balance_key(model, zonal_mean, **solve) -> str:
    """A key of everything that enters the balance solve: the grid
    parameters but for lDim (the solve replaces it), the equation set, the
    physics, every option, the time step, the reference column's file, the
    zonal-mean state and the solve's own settings."""
    h = hashlib.sha256()
    gp = dataclasses.replace(model.grid_params, lDim=0)
    h.update(repr(gp).encode())
    h.update(json.dumps([model.equation_set, model.ts, model.physical_params,
                         model.opts(), solve], sort_keys=True, default=str).encode())
    with open(model.ref_state_file, "rb") as f:
        h.update(f.read())
    h.update(np.ascontiguousarray(zonal_mean, np.float64).tobytes())
    return h.hexdigest()[:16]


def balanced_delta(model, grid, ctx, *, cache_dir=None, device="cuda", verbose=False,
                   nl_solve=4, iters=3):
    """(delta [nvars, rDim, 1, zDim], history): the balance correction of
    the unperturbed zonal mean, solved on ``device`` in float64 (or loaded
    from ``cache_dir`` under its key; history None then)."""
    from ..balance import balance_zonal_state

    base0 = initial_fields(grid, ctx.ref_state, perturb=False)
    zm = base0.mean(axis=2)
    path = None
    if cache_dir:
        key = balance_key(model, zm, nl_solve=nl_solve, iters=iters)
        path = os.path.join(cache_dir, f"jw06_balance_{key}.npz")
        if os.path.exists(path):
            return (np.load(path)["bal"] - zm)[:, :, None, :], None
    bal, info = balance_zonal_state(model, zm, nl_solve=nl_solve, iters=iters,
                                    verbose=verbose, device=device)
    if path:
        np.savez(path, bal=bal)
    return (bal - zm)[:, :, None, :], info["history"]


def prepare_run(model, phys0, dtype, device="cuda"):
    """(grid, ctx, state, step) of a run from the physical fields ``phys0``
    (float64 numpy) on ``device``: the slim semi-implicit history, and the
    top sponge relaxing toward the state the run starts from."""
    from .. import create_grid
    from .. import timeintegration as ti
    from ..model import _set_boundary_refs, build_context, build_step

    grid = create_grid(model.grid_params, dtype, device=device)
    ctx = build_context(model, grid, dtype)
    spec0 = grid.analysis(torch.as_tensor(phys0, dtype=dtype, device=grid.device))
    state = ti.initial_state(spec0, (grid.nvars,) + grid.spatial_shape, dtype, imp_rows=2)
    _set_boundary_refs(ctx, grid, spec0)
    return grid, ctx, state, build_step(model, grid, ctx, dtype)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU in float64")
    ap.add_argument("--days", type=float, default=9.0)
    ap.add_argument("--cells", type=int, default=24)
    ap.add_argument("--nl", type=int, default=96)
    ap.add_argument("--zdim", type=int, default=24)
    ap.add_argument("--ts", type=float, default=15.0,
                    help="below the buoyancy CFL, ts < ~0.7/N (~20 s)")
    ap.add_argument("--steady", action="store_true",
                    help="the unperturbed steady state (JW06 part 1)")
    ap.add_argument("--filter-tau", type=float, default=0.0)
    ap.add_argument("--filter-axes", default="rl")
    ap.add_argument("--filter-order", type=int, default=4)
    ap.add_argument("--l-q", type=float, default=2.0)
    ap.add_argument("--smag", type=float, default=0.0)
    ap.add_argument("--sponge-top-km", type=float, default=0.0)
    ap.add_argument("--sponge-top-tau", type=float, default=600.0)
    ap.add_argument("--k4", type=float, default=0.0)
    ap.add_argument("--ivd", action="store_true")
    ap.add_argument("--ivd-no-w", action="store_true")
    ap.add_argument("--balanced-init", action="store_true",
                    help="solve the model's discrete balance for the zonal mean")
    ap.add_argument("--balance-cache", action="store_true",
                    help="keep / reuse the solved correction in --out, keyed on "
                    "everything that enters the solve")
    ap.add_argument("--out", default="./jw06_out")
    args = ap.parse_args(argv)

    from .. import create_grid
    from ..model import build_context, make_scan

    device = "cpu" if args.cpu else "cuda"
    dtype = torch.float64 if args.cpu else torch.float32
    model = build_model(args.out, num_cells=args.cells, nl=args.nl, zdim=args.zdim,
                        ts=args.ts, t_end=args.days * 86400.0,
                        filter_tau=args.filter_tau, filter_axes=args.filter_axes,
                        filter_order=args.filter_order, smag=args.smag, l_q=args.l_q,
                        sponge_top=args.sponge_top_km * 1.0e3,
                        sponge_top_tau=args.sponge_top_tau, k4=args.k4,
                        ivd=args.ivd, ivd_no_w=args.ivd_no_w)
    # the initial fields from a float64 grid's points and reference column
    grid64 = create_grid(model.grid_params, torch.float64, device="cpu")
    ctx64 = build_context(model, grid64, torch.float64)
    phys0 = initial_fields(grid64, ctx64.ref_state, perturb=not args.steady)
    if args.balanced_init:
        delta, history = balanced_delta(
            model, grid64, ctx64, cache_dir=args.out if args.balance_cache else None,
            device=device, verbose=True)
        print("balanced init: " + ("loaded from the cache" if history is None else
                                   "max|residual| " + " -> ".join(f"{h:.3e}" for h in history)))
        phys0 = phys0 + delta
    grid, ctx, state, step = prepare_run(model, phys0, dtype, device)
    per = int(round(86400.0 / model.ts))  # report daily
    run_day = make_scan(step, per)

    print(" day   u_max   |v|_max  ps_min(hPa)  ps_max(hPa)  ps_eddy_min")
    um, vm, pmn, pmx, pse = diagnostics(grid, ctx.ref_state, phys0)
    print(f"{0:4.0f} {um:7.2f} {vm:8.3f} {pmn:10.2f} {pmx:10.2f} {pse:10.2f}", flush=True)
    u0max = um
    for day in range(1, int(args.days) + 1):
        state = run_day(state)
        phys = grid.synthesis(state.spec)["val"].cpu().numpy()
        if not np.isfinite(phys).all():
            print(f"NONFINITE at day {day}")
            return 1
        um, vm, pmn, pmx, pse = diagnostics(grid, ctx.ref_state, phys)
        print(f"{day:4.0f} {um:7.2f} {vm:8.3f} {pmn:10.2f} {pmx:10.2f} {pse:10.2f}",
              flush=True)
    if args.steady:
        print(f"steady-state drift: u_max {u0max:.2f} -> {um:.2f} m/s")
    else:
        print("published (JW06 Fig. 6, four reference cores): ps_min ~997 hPa day 4, "
              "~980 day 6, ~940-960 day 8, <930 day 10; compare 1000 + ps_eddy_min")
    return 0


if __name__ == "__main__":
    sys.exit(main())
