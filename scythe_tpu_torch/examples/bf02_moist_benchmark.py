"""Bryan & Fritsch (2002) saturated moist benchmark, in PyTorch: the port
of ``examples/bf02_moist_benchmark.py``.

Setup per BF02 (MWR 130, 2917-2928): 2-D x-z domain 20 km wide x 10 km
deep, periodic lateral, rigid free-slip lids; base state saturated
everywhere, neutral to reversible moist ascent (theta_e = 320 K, total
water r_t = 0.020 kg/kg at 1000 hPa); perturbation theta_rho' = 2 K
cos^2(pi R / 2) inside R < 1, R^2 = ((x-xc)/2 km)^2 + ((z - 2 km)/2 km)^2,
moisture re-saturated at constant r_t; integrate 1000 s.

Published numbers (their Figs. 3-6, Delta = 100 m run): maximum updraft
~14.3 m/s at t = 1000 s (reproductions land in 13.9-14.6); theta_e is
materially conserved, so its extrema must not grow beyond the initial
range.

BF02_test with the base state built through ``exact_reference_state``: the
(sbar, xibar, mubar, mu_lbar) profiles come from hydrostatic integration
under the model's own thermodynamics, so "saturated, neutral, r_t = 0.020"
holds in the model's state variables.  The published run: 64 cells x 64
levels, ts 0.1 s, 1000 s = 10,000 steps, one column solve of 192 x 64
columns a step.

Run:  python -m scythe_tpu_torch.examples.bf02_moist_benchmark [--cpu]
      [--cells 64] [--zdim 64] [--ts 0.1] [--t-end 1000] [--out DIR]
(float32 on the card, float64 with --cpu.)
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import BC, ZBC, GridParameters, ModelParameters
from ..basis import chebyshev
from ..device import DEFAULT
from ..io import _write_csv
from ..physics import thermodynamics as td

THETA_E = 320.0
R_T = 0.020
P_SFC = 1000.0  # hPa
LX = 20.0e3
LZ = 10.0e3
VARS = {"s": 1, "xi": 2, "mu": 3, "u": 4, "w": 5, "mu_l": 6, "qss": 7}


def _es(T, p):
    return td.on_host(td.sat_pressure_liquid_buck, T, p)


def _theta_e_sat(T, p):
    """The model's reversible theta_e (thermodynamics.reversible_theta_e
    with H = 1) as a function of (T, p hPa) on the saturated r_t = R_T
    surface: q_v = q_sat(T, p), q_l = R_T - q_v."""
    es = _es(T, p)
    qv = td.Eps * es / (p - es)
    cp = td.Cpd + td.Cl * R_T
    theta_term = T * (td.p_0 / (p - es)) ** (td.Rd / cp)
    return theta_term * np.exp(td.L_v(T) * qv / (cp * T))


def _solve_T(p, target, T0=290.0, fn=_theta_e_sat):
    """Newton solve fn(T, p) = target (scalar or arrays)."""
    T = np.asarray(T0, np.float64) * np.ones_like(np.asarray(p, np.float64))
    for _ in range(40):
        f = fn(T, p) - target
        df = (fn(T + 0.01, p) - fn(T - 0.01, p)) / 0.02
        dT = f / df
        T = T - dT
        if np.max(np.abs(dT)) < 1e-12:
            break
    return T


def base_state_profiles(zpts):
    """Hydrostatic saturated moist-adiabatic column on the given z points,
    integrated with the model's own reversible phase-change thermodynamics:
    the saturated adiabat through BF02's surface anchor (theta_e = 320 K,
    r_t = 0.020 at 1000 hPa), so the model, whose entropy carries the
    s_condensation exchange term, sees an exactly neutral column.

    Along the ascent: ds = dq_v (L_v C_m / T + C_l ln(T/T_0))
    - C_m (R_d + q_v R_v) d ln(rho_d), the inverse of the model's
    s_condensation source and the entropy-divergence forcing followed along
    the parcel.  Integrated at 5 m, then interpolated; returns a dict of
    numpy profiles."""
    def sat_state(T, p):
        es = float(_es(T, p))
        qv = td.Eps * es / (p - es)
        rho_d = 100.0 * (p - es) / (td.Rd * T)
        s = float(td.on_host(td.entropy, T, rho_d, qv))
        return qv, rho_d, s

    def ds_dqv(T, qv, ql):
        # inverse of s_condensation at saturation (e = e_s)
        Cm = (ql * td.Cl) / (td.Cvd + qv * td.Cvv + ql * td.Cl)
        return float(td.L_v(T)) * Cm / T + td.Cl * np.log(T / td.T_0)

    dz = 5.0
    zf = np.arange(0.0, float(np.max(zpts)) + 2 * dz, dz)
    p = np.empty_like(zf)
    T = np.empty_like(zf)
    p[0] = P_SFC
    T[0] = float(_solve_T(p[0], THETA_E))  # BF02 surface anchor

    for i in range(1, len(zf)):
        qv0, rho_d0_, s0 = sat_state(T[i - 1], p[i - 1])
        rho_t0 = rho_d0_ * (1.0 + R_T)
        # provisional half-step pressure, then full step with midpoint rho
        ph = p[i - 1] - 0.5 * dz * td.GRAVITY * rho_t0 / 100.0

        def solve_level(p_new, T_guess):
            # Newton on T: entropy(T) - s0 =
            #   (qv(T) - qv0) ds_dqv(mid) - Cm(Rd+qv Rv)|mid dln(rho_d)
            T_n = T_guess

            def resid(T_n):
                qv_n, rho_dn, s_n = sat_state(T_n, p_new)
                qm = 0.5 * (qv_n + qv0)
                Tm = 0.5 * (T_n + T[i - 1])
                coef = ds_dqv(Tm, qm, R_T - qm)
                Cm = ((R_T - qm) * td.Cl) / (td.Cvd + qm * td.Cvv + (R_T - qm) * td.Cl)
                div_term = Cm * (td.Rd + qm * td.Rv) * np.log(rho_dn / rho_d0_)
                return (s_n - s0) - (qv_n - qv0) * coef + div_term

            for _ in range(30):
                f = resid(T_n)
                eps = 1e-3
                dT = f / ((resid(T_n + eps) - f) / eps)
                T_n = T_n - dT
                if abs(dT) < 1e-11:
                    break
            return T_n

        Th = solve_level(ph, T[i - 1])
        qvh, rho_dh, _ = sat_state(Th, ph)
        p[i] = p[i - 1] - dz * td.GRAVITY * (rho_dh * (1.0 + R_T)) / 100.0
        T[i] = solve_level(p[i], Th)

    pz = np.interp(zpts, zf, p)
    Tz = np.interp(zpts, zf, T)
    es = _es(Tz, pz)
    qv = td.Eps * es / (pz - es)
    ql = R_T - qv
    if np.any(ql < 0):
        raise ValueError("base state unsaturated: r_t too small")
    rho_d = 100.0 * (pz - es) / (td.Rd * Tz)
    return dict(
        T=Tz, p=pz, qv=qv, ql=ql, rho_d=rho_d,
        s=td.on_host(td.entropy, Tz, rho_d, qv),
        xi=td.on_host(td.log_dry_density, rho_d),
        mu=td.on_host(td.bhyp, qv),
        mu_l=td.on_host(td.bhyp, ql),
    )


def write_reference_file(path, gp):
    """Exact (pre-balanced) reference-state file on the model levels."""
    zops = chebyshev.build_ops(gp.zDim, gp.zmin, gp.zmax, gp.b_zDim)
    prof = base_state_profiles(zops.points)
    with open(path, "w") as f:
        for z, s, xi, mu, ml in zip(zops.points, prof["s"], prof["xi"], prof["mu"],
                                    prof["mu_l"]):
            f.write(f"{z} {s} {xi} {mu} {ml}\n")
    return path


def build_model(out_dir, num_cells=64, zdim=64, ts=0.1, t_end=1000.0,
                diagnostic=True, filter_tau=30.0, smag=0.0):
    """``diagnostic=True`` (default) uses the rate-capped saturation
    adjustment, the analog of BF02's own instantaneous adjustment (the
    prognostic-qss scheme rings on this everywhere-saturated setup at
    Delta <= 150 m).  ``filter_tau`` enables the tau-second modal filter."""
    os.makedirs(out_dir, exist_ok=True)
    gp = GridParameters(
        geometry="RZ",
        xmin=-LX / 2,
        xmax=LX / 2,
        num_cells=num_cells,
        zmin=0.0,
        zmax=LZ,
        zDim=zdim,
        BCL={n: BC.PERIODIC for n in VARS},
        BCR={n: BC.PERIODIC for n in VARS},
        # every K-diffused variable gets R1T1 at the rigid lids (with the
        # default unconstrained fit the walls pump exponentially)
        BCB={"s": ZBC.R1T1, "u": ZBC.R1T1, "mu": ZBC.R1T1,
             "mu_l": ZBC.R1T1, "w": ZBC.R1T0},
        BCT={"s": ZBC.R1T1, "u": ZBC.R1T1, "mu": ZBC.R1T1,
             "mu_l": ZBC.R1T1, "w": ZBC.R1T0},
        vars=VARS,
    )
    return ModelParameters(
        ts=ts,
        integration_time=t_end,
        output_interval=t_end,
        equation_set="BF02_test",
        initial_conditions=os.path.join(out_dir, "ics.csv"),
        output_dir=out_dir,
        ref_state_file=write_reference_file(os.path.join(out_dir, "ref.txt"), gp),
        grid_params=gp,
        physical_params={"K": 20.0},
        options={
            "semiimplicit": True,
            "exact_reference_state": True,
            "stiff_relaxation": "exp",
            **({"condensation": "diagnostic"} if diagnostic else {}),
            **({"modal_filter_tau": float(filter_tau)} if filter_tau else {}),
            **({"smagorinsky": float(smag)} if smag else {}),
        },
    )


def _columns(ref_state):
    """(sbar, xibar, mubar, mu_lbar) columns, float64 numpy [nz]."""
    return tuple(np.asarray(a[:, 0].detach().cpu(), np.float64)
                 for a in (ref_state.sbar, ref_state.xibar, ref_state.mubar,
                           ref_state.mu_lbar))


def write_ics(model, grid, ref_state):
    """BF02 theta_rho bubble: at each gridpoint the saturated (r_t-conserving,
    pressure-unchanged) state whose theta_rho equals base + 2 K
    cos^2(pi R / 2), stored as perturbations of the model's own smoothed
    base profiles."""
    pts = grid.gridpoints()
    shape = grid.spatial_shape
    x = pts[:, 0].reshape(shape)
    z = pts[:, 1].reshape(shape)

    sbar, xibar, mubar, mu_lbar = _columns(ref_state)
    _, _, T_b, p_b = td.on_host(td.thermodynamic_tuple, sbar, xibar, mubar)

    def theta_rho_sat(T, p):
        es = _es(T, p)
        qv = td.Eps * es / (p - es)
        theta = T * (td.p_0 / p) ** (td.Rd / td.Cpd)
        return theta * (1.0 + qv / td.Eps) / (1.0 + R_T)

    R = np.sqrt((x / 2000.0) ** 2 + ((z - 2000.0) / 2000.0) ** 2)
    pert = 2.0 * np.cos(0.5 * np.pi * np.minimum(R, 1.0)) ** 2

    target = theta_rho_sat(T_b, p_b)[None, :] + pert  # [nx, nz]
    p2 = np.broadcast_to(p_b[None, :], shape)
    T2 = _solve_T(p2, target, T0=np.broadcast_to(T_b[None, :], shape), fn=theta_rho_sat)
    es2 = _es(T2, p2)
    qv2 = td.Eps * es2 / (p2 - es2)
    ql2 = R_T - qv2
    rho_d2 = 100.0 * (p2 - es2) / (td.Rd * T2)

    cols = {
        "s": td.on_host(td.entropy, T2, rho_d2, qv2) - sbar[None, :],
        "xi": td.on_host(td.log_dry_density, rho_d2) - xibar[None, :],
        "mu": td.on_host(td.bhyp, qv2) - mubar[None, :],
        "mu_l": td.on_host(td.bhyp, ql2) - mu_lbar[None, :],
    }
    names = list(model.grid_params.vars)
    data = np.zeros((pts.shape[0], 2 + len(names)))
    data[:, :2] = pts
    for j, n in enumerate(names):
        if n in cols:
            data[:, 2 + j] = cols[n].ravel()
    _write_csv(model.initial_conditions, ["r", "z", *names], data)


def diagnostics(grid, ref_state, phys):
    """(w_max, theta_rho' extrema, theta_e extrema): theta_e is a material
    invariant of reversible saturated flow, so its extrema must not grow
    beyond the initial range (BF02's conservation criterion, their Fig. 2)."""
    shape = grid.spatial_shape
    sb, xib, mub, mlb = _columns(ref_state)
    phys = np.asarray(phys, np.float64)
    s = phys[0].reshape(shape) + sb[None, :]
    xi = phys[1].reshape(shape) + xib[None, :]
    mu = phys[2].reshape(shape) + mub[None, :]
    ml = phys[5].reshape(shape) + mlb[None, :]
    w = phys[4].reshape(shape)
    tp = (td.on_host(td.theta_rho, s, xi, mu, ml)
          - td.on_host(td.theta_rho, sb, xib, mub, mlb)[None, :])
    the = td.on_host(td.reversible_theta_e, s, xi, mu, ml)
    return (float(w.max()), float(tp.max()), float(tp.min()),
            float(the.min()), float(the.max()))


def simulate(model, dtype=None, device=DEFAULT, report_every=100.0):
    """The run from the model's IC file on ``device`` (the card unless the
    caller asks for the CPU), the diagnostics every ``report_every``
    seconds.  Returns (grid, ctx, [(t, diagnostics), ...]) from t = 0."""
    from .straka_density_current import snapshots

    grid, ctx, runs = snapshots(model, int(round(model.integration_time / report_every)),
                                dtype, device)
    return grid, ctx, [(t, diagnostics(grid, ctx.ref_state, phys)) for t, phys in runs]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    ap.add_argument("--cells", type=int, default=64)
    ap.add_argument("--zdim", type=int, default=64)
    ap.add_argument("--ts", type=float, default=0.1)
    ap.add_argument("--t-end", type=float, default=1000.0)
    ap.add_argument("--out", default="./bf02_out")
    ap.add_argument("--prognostic", action="store_true",
                    help="reference-matching prognostic qss instead of the "
                    "BF02-faithful diagnostic saturation adjustment")
    ap.add_argument("--filter-tau", type=float, default=30.0,
                    help="modal filter e-folding (0 = off)")
    ap.add_argument("--smag", type=float, default=0.0)
    args = ap.parse_args(argv)
    from .. import create_grid
    from ..model import build_context

    model = build_model(args.out, num_cells=args.cells, zdim=args.zdim, ts=args.ts,
                        t_end=args.t_end, diagnostic=not args.prognostic,
                        filter_tau=args.filter_tau, smag=args.smag)
    grid = create_grid(model.grid_params, torch.float64, device="cpu")  # the ICs
    write_ics(model, grid, build_context(model, grid, torch.float64).ref_state)
    _, _, rows = simulate(model, torch.float64 if args.cpu else torch.float32,
                          "cpu" if args.cpu else DEFAULT)
    print("  t(s)   w_max  trho'_max  trho'_min  the_min   the_max")
    for t, (wm, tmx, tmn, te0, te1) in rows:
        print(f"{t:6.0f} {wm:7.2f} {tmx:10.2f} {tmn:10.2f} {te0:9.3f} {te1:9.3f}")
    te_start, te_end = rows[0][1], rows[-1][1]
    print(
        f"published (BF02 Delta=100m): w_max(1000s) ~14.3 m/s "
        f"(reproductions 13.9-14.6); measured {te_end[0]:.2f}; theta_e range drift "
        f"[{te_end[3] - te_start[3]:+.3f}, {te_end[4] - te_start[4]:+.3f}] K"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
