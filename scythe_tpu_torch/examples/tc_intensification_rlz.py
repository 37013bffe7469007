"""Surface-flux-driven tropical-cyclone intensification on the RLZ moist
core, in PyTorch: the port of ``examples/tc_intensification_rlz.py``.

``MoistEulerRLZ`` run near-axisymmetric (lDim 4) with bulk air-sea fluxes,
active rain sedimentation, exp stiff relaxation, the semi-implicit vertical
acoustic solve and a Rayleigh sponge at the open outer boundary, over a
Jordan-like tropical sounding, from a gradient-balanced vortex.  The
functions keep the JAX example's names and arguments; they use the port's
thermodynamics.

``tc_mature_model(out_dir)`` is the mature-TC configuration of
``models/tc_mature_rlz.py`` (the round-4 "sweep 10" bundle: 100 cells,
diagnostic condensation capped at 2e-4 with tau 30 s, Smagorinsky Cs 0.2
with implicit vertical diffusion, a deep moist core and a 15 m/s vortex)
with its initial conditions written under ``out_dir``:

    import torch, scythe_tpu_torch as tx
    from scythe_tpu_torch.examples.tc_intensification_rlz import tc_mature_model
    grid, phys = tx.integrate_model(tc_mature_model("tc_out"),
                                    dtype=torch.float32, device="cuda")
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import BC, ZBC, GridParameters, ModelParameters, create_grid
from ..physics import thermodynamics as td

VARS = {
    "s": 1, "xi": 2, "mu": 3, "u": 4, "v": 5, "w": 6,
    "mu_c": 7, "mu_r": 8, "qss": 9,
}
F_COR = 5.0e-5
SST = 301.15  # 28 C
RMAX_DOM = 500.0e3
ZTOP = 20.0e3


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def jordan_sounding(path, rh=0.7, qv0=16.0):
    """Jordan-like mean tropical sounding written to ``path``: moist BL,
    conditionally unstable troposphere, isothermal ~203 K stratosphere above
    15 km; the smooth humidity profile is capped at ``rh`` of saturation of
    an approximate hydrostatic column (the JAX example's construction)."""
    zs = np.linspace(0.0, 24000.0, 97)
    ztr, thtr, ttr = 15000.0, 365.0, 203.0
    theta = np.where(
        zs <= ztr,
        300.0 + (thtr - 300.0) * (zs / ztr) ** 1.25,
        thtr * np.exp(9.81 / (1004.0 * ttr) * (zs - ztr)),
    )
    x = (zs - 1000.0) / 2700.0
    qv = qv0 * np.exp(-(np.logaddexp(0.0, x) - np.logaddexp(0.0, x[0])))
    qv = np.maximum(qv * np.exp(-((zs / 11000.0) ** 8)), 0.003)
    kappa = 287.0 / 1004.0
    p = np.empty_like(zs)
    T = np.empty_like(zs)
    p[0] = 1015.0e2
    T[0] = theta[0] * (p[0] / 1.0e5) ** kappa
    for i in range(1, len(zs)):
        dz = zs[i] - zs[i - 1]
        Ti = theta[i] * (p[i - 1] / 1.0e5) ** kappa  # provisional
        rho = p[i - 1] / (287.0 * 0.5 * (T[i - 1] + Ti))
        p[i] = p[i - 1] - rho * 9.81 * dz
        T[i] = theta[i] * (p[i] / 1.0e5) ** kappa
    tc = T - 273.15
    es = 6.1121 * np.exp((18.678 - tc / 234.5) * tc / (257.14 + tc))  # hPa
    qsat = 622.0 * es / (p / 100.0 - es)  # g/kg
    qv = np.minimum(qv, rh * qsat)
    with open(path, "w") as f:
        f.write(f"1015.0 {theta[0]} {qv[0]}\n")
        for z, th, q in zip(zs[1:], theta[1:], qv[1:]):
            f.write(f"{z} {th} {q}\n")
    return path


def initial_vortex(r, z, vmax=12.0, rm=82.5e3):
    """RE87-style vortex, tapered to zero at the model top."""
    s = np.maximum(r, 1.0) / rm
    taper = np.cos(0.5 * np.pi * np.minimum(z / ZTOP, 1.0)) ** 2
    return vmax * s * np.exp(1.0 - s) * taper


def build_model(out_dir, num_cells=50, ts=2.0, t_end=48 * 3600.0,
                fluxes=True, stable=False, cap=None, filter_tau=0.0,
                filter_axes="l", rh=0.7, qv0=16.0, smag=0.0, ivd=False,
                cond_tau=0.0):
    """The example's ModelParameters (its sounding written under
    ``out_dir``); the options as the JAX example sets them."""
    os.makedirs(out_dir, exist_ok=True)
    gp = GridParameters(
        geometry="RLZ",
        xmin=0.0,
        xmax=RMAX_DOM,
        num_cells=num_cells,
        lDim=4,
        zmin=0.0,
        zmax=ZTOP,
        zDim=24,
        BCL={"u": BC.R1T0, "v": BC.R1T0, "w": BC.R1T1},
        BCR={"u": BC.R1T0, "v": BC.R0},
        BCB={"s": ZBC.R1T1, "u": ZBC.R1T1, "v": ZBC.R1T1, "mu": ZBC.R1T1,
             "mu_c": ZBC.R1T1, "w": ZBC.R1T0},
        BCT={"s": ZBC.R1T1, "u": ZBC.R1T1, "v": ZBC.R1T1, "mu": ZBC.R1T1,
             "mu_c": ZBC.R1T1, "mu_r": ZBC.R1T1, "w": ZBC.R1T0},
        vars=VARS,
    )
    options = {
        "semiimplicit": True,
        "sedimentation": "active",
        "stiff_relaxation": "exp",
        "sponge_width": 100.0e3,
        "sponge_tau": 1800.0,
    }
    if stable:
        options["condensation"] = "diagnostic"
    if cond_tau > 0.0:
        options["condensation_tau"] = float(cond_tau)
    if cap is not None:
        options["condensation_rate_cap"] = float(cap)
    if filter_tau > 0.0:
        # the modal filter is not ported: build_step raises on it
        options["modal_filter_tau"] = float(filter_tau)
        options["modal_filter_axes"] = filter_axes
    if smag > 0.0:
        options["smagorinsky"] = float(smag)
    if ivd:
        options["implicit_vdiff"] = True
    if fluxes:
        options["surface_fluxes"] = {
            "sst": SST, "Ck": 1.2e-3, "Cd": 1.5e-3, "depth": 600.0,
            "wind_floor": 2.0,
        }
    return ModelParameters(
        ts=ts,
        integration_time=t_end,
        output_interval=2.0 * 3600.0,
        equation_set="MoistEulerRLZ",
        initial_conditions=os.path.join(out_dir, "ics.csv"),
        output_dir=out_dir,
        ref_state_file=jordan_sounding(os.path.join(out_dir, "snd.txt"),
                                       rh=rh, qv0=qv0),
        grid_params=gp,
        physical_params={"K": 50.0, "f": F_COR},
        options=options,
    )


def write_ics(model, grid, ref_state, bubble=0.0, vmax=12.0,
              moist_core=0.0, moist_core_depth=6000.0):
    """The IC CSV at ``model.initial_conditions``: a vortex in approximate
    gradient balance (xi' = p'/P_xi with dp'/dr = rho_bar (f v + v^2/r)
    integrated inward from the outer boundary), an optional moist envelope
    raised toward ``moist_core`` of saturation at fixed temperature inside
    (r < 120 km, z < moist_core_depth), and an optional warm, moist bubble
    of ``bubble`` K at (60 km, 1.5 km); as the JAX example's write_ics."""
    pts = grid.gridpoints()
    shape = grid.spatial_shape
    r = pts[:, 0].reshape(shape)
    z = pts[:, 2].reshape(shape)
    v0 = initial_vortex(r, z, vmax=vmax)

    rs = ref_state
    sbar, xibar, mubar = (_host(a[:, 0]) for a in (rs.sbar, rs.xibar, rs.mubar))
    q_v, rho_d, Tk, p = (
        a.numpy() for a in td.thermodynamic_tuple(
            *(torch.from_numpy(a) for a in (sbar, xibar, mubar))
        )
    )
    rho_bar = rho_d * (1.0 + q_v)  # [nz]
    pxi = _host(rs.Pxi_prof) * rho_bar  # P_xi = pxi_prof*rho(1+q) [Pa]

    r1 = r[:, 0, :]  # [nr, nz] (l-invariant)
    v1 = v0[:, 0, :]
    integrand = rho_bar[None, :] * (F_COR * v1 + v1 * v1 / np.maximum(r1, 1.0))
    dp = np.zeros_like(r1)
    dr_seg = np.diff(r1, axis=0)
    seg = 0.5 * (integrand[1:, :] + integrand[:-1, :]) * dr_seg
    dp[:-1, :] = -np.cumsum(seg[::-1, :], axis=0)[::-1, :]
    xi_p = dp / pxi[None, :]

    mu_core = np.zeros(shape)
    s_core = np.zeros(shape)
    if moist_core > 0.0:
        q_sat_bar = td.on_host(td.q_sat_liquid, Tk, p)  # [nz]
        envr = np.cos(0.5 * np.pi * np.minimum(r / 120.0e3, 1.0)) ** 2
        envz = np.cos(
            0.5 * np.pi * np.minimum(z / moist_core_depth, 1.0)) ** 2
        frac = moist_core * envr * envz
        q_tgt = q_v[None, None, :] + np.maximum(
            0.0, frac * (q_sat_bar[None, None, :] - q_v[None, None, :]))
        mu_core = td.on_host(td.bhyp, q_tgt) - td.on_host(td.bhyp, q_v)[None, None, :]
        # moisten at fixed temperature (s carries L_v q / T)
        s_core = (
            td.on_host(td.entropy, Tk[None, None, :], rho_d[None, None, :], q_tgt)
            - td.on_host(td.entropy, Tk, rho_d, q_v)[None, None, :]
        )

    s_pert = np.zeros(shape)
    mu_pert = np.zeros(shape)
    if bubble > 0.0:
        rad = np.sqrt(((r - 60.0e3) / 30.0e3) ** 2
                      + ((z - 1500.0) / 1500.0) ** 2)
        env = np.maximum(
            0.0, np.cos(0.5 * np.pi * np.minimum(rad, 1.0))) ** 2
        s_pert = (1004.0 * bubble / 300.0) * env
        q_sat_bar = td.on_host(td.q_sat_liquid, Tk, p)  # [nz]
        q_bub = q_v[None, None, :] + 0.95 * env * (
            q_sat_bar[None, None, :] - q_v[None, None, :])
        mu_pert = (td.on_host(td.bhyp, np.maximum(q_bub, q_v[None, None, :]))
                   - td.on_host(td.bhyp, q_v)[None, None, :])

    from ..io import _write_csv

    names = list(model.grid_params.vars)
    cols = {
        "v": v0,
        "xi": np.broadcast_to(xi_p[:, None, :], shape),
        "s": s_pert + s_core,
        "mu": mu_pert + mu_core,
    }
    data = np.zeros((pts.shape[0], 3 + len(names)))
    data[:, :3] = pts
    for j, n in enumerate(names):
        if n in cols:
            data[:, 3 + j] = np.asarray(cols[n]).ravel()
    _write_csv(model.initial_conditions, ["r", "l", "z", *names], data)


def intensity(grid, phys, ref_state=None):
    """(vmax, r_vmax km, w_max, qr_max, qc_max, RH_max below ~8 km, u_min =
    strongest BL inflow) of a physical state [nvars, *spatial] (numpy)."""
    sh = grid.spatial_shape
    v = phys[4].reshape(sh)
    w = phys[5].reshape(sh)
    qr = phys[7].reshape(sh)
    qc = phys[6].reshape(sh)
    vmax = float(v.max())
    r_at = grid.gridpoints()[:, 0].reshape(sh)
    j = np.unravel_index(v.argmax(), v.shape)
    rh_max = float("nan")
    if ref_state is not None:
        rs = ref_state
        s_t = phys[0].reshape(sh) + _host(rs.sbar[:, 0])[None, None, :]
        xi_t = phys[1].reshape(sh) + _host(rs.xibar[:, 0])[None, None, :]
        mu_t = phys[2].reshape(sh) + _host(rs.mubar[:, 0])[None, None, :]
        q_v, _, Tk, pp = (
            a.numpy() for a in td.thermodynamic_tuple(
                *(torch.from_numpy(np.asarray(a, np.float64)) for a in (s_t, xi_t, mu_t))
            )
        )
        qs = td.on_host(td.q_sat_liquid, Tk, pp)
        z = np.asarray(grid.z_mish)
        low = z < 8000.0
        rh_max = float((q_v[..., low] / qs[..., low]).max())
    u_min = float(phys[3].reshape(sh)[..., 0].min())
    return (vmax, float(r_at[j]) / 1000.0, float(w.max()),
            float(np.maximum(qr, 0).max()),
            float(np.maximum(td.on_host(td.ahyp, qc), 0).max()),
            rh_max, u_min)


def tc_mature_model(out_dir, t_end=150 * 3600.0, output_interval=2.0 * 3600.0,
                    num_cells=100, ts=2.0):
    """The mature-TC configuration (``models/tc_mature_rlz.py``, round-4
    sweep 10) with its ICs (15 m/s vortex, 85%-saturated moist core 10 km
    deep) written under ``out_dir``.  ``t_end`` and ``output_interval`` cut
    the simulated time; ``num_cells``/``ts`` give the reduced-size contract
    of tests/test_tc_intensification.py (16 cells, ts 4 s)."""
    from ..model import build_context

    model = build_model(
        out_dir, num_cells=num_cells, ts=ts, t_end=t_end, fluxes=True,
        stable=True, cap=2.0e-4, rh=0.9, qv0=20.0, smag=0.20, ivd=True,
        cond_tau=30.0,
    ).with_(output_interval=output_interval)
    grid = create_grid(model.grid_params, torch.float64, device="cpu")  # the ICs
    ctx = build_context(model, grid, torch.float64)
    write_ics(model, grid, ctx.ref_state, vmax=15.0, moist_core=0.85,
              moist_core_depth=10000.0)
    return model
