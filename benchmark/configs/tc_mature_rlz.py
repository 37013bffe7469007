"""Inputs of ``tc_mature_rlz``: the Jordan-like tropical sounding and the
initial conditions of ``scythe_tpu_torch/examples/tc_intensification_rlz.py``
(a gradient-balanced RE87-style vortex and an 85%-saturated moist core),
made here in NumPy with the reference's thermodynamics, with a perturbation
drawn from the seed (``tc_mature_rlz.json`` under ``ics``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from benchmark.reference import reference_state as rsmod
from benchmark.reference import thermodynamics as td

ZTOP = 20.0e3


def jordan_sounding(path, rh, qv0):
    """The sounding file: moist BL, conditionally unstable troposphere,
    isothermal ~203 K stratosphere above 15 km, humidity capped at ``rh`` of
    saturation (the example's ``jordan_sounding``)."""
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
        Ti = theta[i] * (p[i - 1] / 1.0e5) ** kappa
        rho = p[i - 1] / (287.0 * 0.5 * (T[i - 1] + Ti))
        p[i] = p[i - 1] - rho * 9.81 * dz
        T[i] = theta[i] * (p[i] / 1.0e5) ** kappa
    tc = T - 273.15
    es = 6.1121 * np.exp((18.678 - tc / 234.5) * tc / (257.14 + tc))
    qsat = 622.0 * es / (p / 100.0 - es)
    qv = np.minimum(qv, rh * qsat)
    with open(path, "w") as f:
        f.write(f"1015.0 {theta[0]} {qv[0]}\n")
        for z, th, q in zip(zs[1:], theta[1:], qv[1:]):
            f.write(f"{z} {th} {q}\n")
    return path


def initial_fields(cfg, grid, ref_state, rng) -> np.ndarray:
    """[nvars, rDim, nl, nz] float64: the example's ``write_ics`` with
    vmax 15 m/s and a moist core of 0.85 over 10 km, each strength moved by
    the seed, and a seeded wave-1 anomaly of the tangential wind."""
    ic = cfg["ics"]
    pert = ic["perturbation"]
    vmax = ic["vmax"] * (1.0 + pert["vmax_frac"] * rng.uniform(-1.0, 1.0))
    core = ic["moist_core"] + pert["moist_core_abs"] * rng.uniform(-1.0, 1.0)
    amp = pert["wave1_amp_ms"] * rng.uniform(0.5, 1.0)
    phase = rng.uniform(0.0, 2.0 * np.pi)
    depth = ic["moist_core_depth"]
    f_cor = cfg["model"]["physical_params"]["f"]

    shape = grid.spatial_shape
    pts = grid.gridpoints()
    r = pts[:, 0].reshape(shape)
    lam = pts[:, 1].reshape(shape)
    z = pts[:, 2].reshape(shape)
    s_r = np.maximum(r, 1.0) / ic["rm"]
    taper = np.cos(0.5 * np.pi * np.minimum(z / ZTOP, 1.0)) ** 2
    v_sym = vmax * s_r * np.exp(1.0 - s_r) * taper
    v0 = v_sym * (1.0 + (amp / vmax) * np.cos(lam - phase))

    rs = ref_state
    sbar, xibar, mubar = (a[:, 0].numpy() for a in (rs.sbar, rs.xibar, rs.mubar))
    q_v, rho_d, Tk, p = (a.numpy() for a in td.thermodynamic_tuple(
        *(torch.from_numpy(a) for a in (sbar, xibar, mubar))))
    rho_bar = rho_d * (1.0 + q_v)
    pxi = rs.Pxi_prof.numpy() * rho_bar

    # gradient balance of the symmetric vortex, integrated inward
    r1 = r[:, 0, :]
    v1 = v_sym[:, 0, :]
    integrand = rho_bar[None, :] * (f_cor * v1 + v1 * v1 / np.maximum(r1, 1.0))
    dp = np.zeros_like(r1)
    seg = 0.5 * (integrand[1:, :] + integrand[:-1, :]) * np.diff(r1, axis=0)
    dp[:-1, :] = -np.cumsum(seg[::-1, :], axis=0)[::-1, :]
    xi_p = dp / pxi[None, :]

    q_sat_bar = td.on_host(td.q_sat_liquid, Tk, p)
    envr = np.cos(0.5 * np.pi * np.minimum(r / 120.0e3, 1.0)) ** 2
    envz = np.cos(0.5 * np.pi * np.minimum(z / depth, 1.0)) ** 2
    q_tgt = q_v[None, None, :] + np.maximum(
        0.0, core * envr * envz * (q_sat_bar[None, None, :] - q_v[None, None, :]))
    mu_core = td.on_host(td.bhyp, q_tgt) - td.on_host(td.bhyp, q_v)[None, None, :]
    s_core = (td.on_host(td.entropy, Tk[None, None, :], rho_d[None, None, :], q_tgt)
              - td.on_host(td.entropy, Tk, rho_d, q_v)[None, None, :])

    names = list(grid.params.vars)
    phys = np.zeros((len(names),) + shape)
    phys[names.index("v")] = v0
    phys[names.index("xi")] = np.broadcast_to(xi_p[:, None, :], shape)
    phys[names.index("s")] = s_core
    phys[names.index("mu")] = mu_core
    return phys


def make_inputs(cfg, grid, run_dir, rng, device):
    """(phys0, ref_state_file) on the reference's float64 CPU ``grid``;
    writes the sounding under ``run_dir``; all on the host."""
    snd = jordan_sounding(os.path.join(run_dir, "sounding.txt"), **cfg["sounding"])
    p = grid.params
    rs = rsmod.interpolate_reference_file(snd, p.zmin, p.zmax, p.zDim, p.b_zDim,
                                          torch.float64, device="cpu")
    return initial_fields(cfg, grid, rs, rng), snd
