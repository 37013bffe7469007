"""Inputs of ``jw06_production_slz``: the Jablonowski & Williamson (2006)
baroclinic wave (Q. J. R. Meteorol. Soc. 132, 2943-2975; their eqs. 2-12
and Table 1), as ``scythe_tpu_torch/examples/jw06_baroclinic_slz.py``
sets it up, made here in NumPy with the reference's thermodynamics.

The analytic state in eta (their T(eta, phi), Phi(eta, phi) and the zonal
jets) is mapped to height by inverting Phi(eta, phi) = g z by Newton's
method, point by point; the phi = 45 deg column is the exact reference
state (written as the reference file, 'z sbar xibar mubar mu_lbar' on the
model levels), and the latitude structure rides in the perturbations of s
and xi against it.  Vapour is a trace (``ics.q_trace_gkg``) everywhere, so
mu's perturbation is 0.  The start is the analytic state, not the model's
discrete balance.  On top: the Gaussian zonal-wind bump of eqs. 11-12 at
40 N, its amplitude (1 m/s) and its centre longitude (20 E) moved by the
seed (``ics.perturbation``), so that each seed is a distinct member.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from benchmark.reference import reference_state as rsmod
from benchmark.reference import thermodynamics as td

# JW06 Table 1
A_SPH = 6.371229e6
OMEGA = 7.29212e-5
G = 9.80616
RD = 287.04
P0 = 1.0e5
U0 = 35.0
T0 = 288.0
GAMMA = 0.005
ETA_T = 0.2
ETA_0 = 0.252
DELTA_T = 4.8e5


def _eta_v(eta):
    return (eta - ETA_0) * np.pi / 2.0


def t_mean(eta):
    """The horizontal-mean temperature (eqs. 4-5)."""
    t = T0 * eta ** (RD * GAMMA / G)
    return np.where(eta < ETA_T, t + DELTA_T * (ETA_T - eta) ** 5, t)


def phi_mean(eta):
    """The horizontal-mean geopotential (eqs. 7-8)."""
    base = T0 * G / GAMMA * (1.0 - eta ** (RD * GAMMA / G))
    above = RD * DELTA_T * (
        (np.log(eta / ETA_T) + 137.0 / 60.0) * ETA_T**5
        - 5.0 * ETA_T**4 * eta
        + 5.0 * ETA_T**3 * eta**2
        - (10.0 / 3.0) * ETA_T**2 * eta**3
        + 1.25 * ETA_T * eta**4
        - 0.2 * eta**5
    )
    return np.where(eta < ETA_T, base - above, base)


def _latitude_factors(phi):
    sinp, cosp = np.sin(phi), np.cos(phi)
    return (-2.0 * sinp**6 * (cosp**2 + 1.0 / 3.0) + 10.0 / 63.0,
            1.6 * cosp**3 * (sinp**2 + 2.0 / 3.0) - np.pi / 4.0)


def temperature(eta, phi):
    """T(eta, phi) (eq. 6)."""
    ev = _eta_v(eta)
    f1, f2 = _latitude_factors(phi)
    return t_mean(eta) + 0.75 * (eta * np.pi * U0 / RD) * np.sin(ev) * np.sqrt(
        np.abs(np.cos(ev))) * (f1 * 2.0 * U0 * np.cos(ev) ** 1.5 + f2 * A_SPH * OMEGA)


def geopotential(eta, phi):
    """Phi(eta, phi) (eq. 9)."""
    ev = _eta_v(eta)
    f1, f2 = _latitude_factors(phi)
    return phi_mean(eta) + U0 * np.cos(ev) ** 1.5 * (
        f1 * U0 * np.cos(ev) ** 1.5 + f2 * A_SPH * OMEGA)


def zonal_wind(eta, phi):
    """u(eta, phi) (eq. 2)."""
    return U0 * np.cos(_eta_v(eta)) ** 1.5 * np.sin(2.0 * phi) ** 2


def eta_at(z, phi):
    """eta where Phi(eta, phi) = g z: Newton's method with a numerical
    derivative, the step clipped to stay on the branch."""
    z = np.asarray(z, np.float64)
    eta = np.full(np.broadcast(z, phi).shape, 0.5)
    for _ in range(60):
        f = geopotential(eta, phi) - G * z
        df = (geopotential(eta * 1.0001, phi) - G * z - f) / (eta * 1e-4)
        d = np.clip(f / df, -0.2, 0.2)
        eta = np.clip(eta - d, 1e-5, 1.5)
        if np.max(np.abs(d)) < 1e-14:
            break
    return eta


def state_at(z, phi, qv):
    """(T, rho_d, u) of the JW06 atmosphere at height ``z`` and latitude
    ``phi``, with vapour ``qv`` (kg/kg) taking its partial pressure."""
    eta = eta_at(z, phi)
    T = temperature(eta, phi)
    p = eta * P0
    e = p * qv / (0.622 + qv)
    return T, (p - e) / (RD * T), zonal_wind(eta, phi)


def reference_column(z, qv):
    """(s, xi, mu) of the phi = 45 deg column on the levels ``z``."""
    T, rho_d, _ = state_at(z, np.pi / 4.0, qv)
    return (td.on_host(td.entropy, T, rho_d, qv), td.on_host(td.log_dry_density, rho_d),
            float(td.on_host(td.bhyp, qv)))


def write_reference_file(path, z, qv):
    s, xi, mu = reference_column(z, qv)
    cols = np.stack([z, s, xi, np.full_like(z, mu), np.zeros_like(z)], axis=1)
    np.savetxt(path, cols, fmt="%.17g")
    return path


def initial_fields(cfg, grid, ref_file, qv, rng) -> np.ndarray:
    """[nvars, nlat, nlon, nz] float64: s and xi against the 45 deg column
    as the model holds it (``ref_file`` read as the exact reference state:
    its truncated Chebyshev fit), u the jets and the seeded bump, the rest
    0."""
    ic = cfg["ics"]
    bump, pert = ic["bump"], ic["perturbation"]
    amp = bump["u_ms"] * (1.0 + pert["amp_frac"] * rng.uniform(-1.0, 1.0))
    lon_c = np.radians(bump["lon_deg"] + pert["lon_deg"] * rng.uniform(-1.0, 1.0))
    lat_c = np.radians(bump["lat_deg"])

    shape = grid.spatial_shape
    pts = grid.gridpoints()
    lat, lon, z = (pts[:, i].reshape(shape) for i in range(3))
    # the state has no longitude dependence: solve one longitude, broadcast
    T, rho_d, u = (np.broadcast_to(a, shape) for a in state_at(z[:, :1], lat[:, :1], qv))
    dist = A_SPH * np.arccos(np.clip(
        np.sin(lat_c) * np.sin(lat) + np.cos(lat_c) * np.cos(lat) * np.cos(lon - lon_c),
        -1.0, 1.0))
    u = u + amp * np.exp(-((dist / (bump["radius_frac"] * A_SPH)) ** 2))

    p = grid.params
    rs = rsmod.exact_reference_state(ref_file, p.zmin, p.zmax, p.zDim, p.b_zDim,
                                     torch.float64, device="cpu")
    sbar, xibar = (a[:, 0].numpy() for a in (rs.sbar, rs.xibar))
    names = list(grid.params.vars)
    phys = np.zeros((len(names),) + shape)
    phys[names.index("s")] = td.on_host(td.entropy, T, rho_d, qv) - sbar
    phys[names.index("xi")] = td.on_host(td.log_dry_density, rho_d) - xibar
    phys[names.index("u")] = u
    return phys


def make_inputs(cfg, grid, run_dir, rng, device):
    """(phys0, ref_state_file) on the reference's float64 CPU ``grid``; writes
    the reference column under ``run_dir``; all on the host."""
    qv = cfg["ics"]["q_trace_gkg"] * 1e-3
    ref = write_reference_file(os.path.join(run_dir, "reference_column.txt"),
                               np.asarray(grid.z_mish), qv)
    return initial_fields(cfg, grid, ref, qv, rng), ref
