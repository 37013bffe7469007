"""Derived diagnostic fields, in PyTorch: the counterpart of
``scythe_tpu.diagnostics``.

The standard cylindrical operators (vorticity, divergence, Okubo-Weiss,
kinetic energy) take the synthesized ``fields`` dict of a grid (value +
derivative slots) and variable indices and return tensors on the fields'
device; the potential-intensity diagnostic works on host columns.
"""

from __future__ import annotations

import numpy as np
import torch

from .physics import thermodynamics as td


def relative_vorticity(fields, r, u_idx: int, v_idx: int) -> torch.Tensor:
    """zeta = v/r + dv/dr - (1/r) du/dlambda  (cylindrical z-vorticity)."""
    v = fields["val"][v_idx]
    vr = fields["dr"][v_idx]
    ul = fields["dl"][u_idx]
    return v / r + vr - ul / r


def divergence(fields, r, u_idx: int, v_idx: int) -> torch.Tensor:
    """div = u/r + du/dr + (1/r) dv/dlambda."""
    u = fields["val"][u_idx]
    ur = fields["dr"][u_idx]
    vl = fields["dl"][v_idx]
    return u / r + ur + vl / r


def okubo_weiss(fields, r, u_idx: int, v_idx: int) -> torch.Tensor:
    """OW = s_n^2 + s_s^2 - zeta^2 (strain vs rotation)."""
    u = fields["val"][u_idx]
    ur = fields["dr"][u_idx]
    ul = fields["dl"][u_idx]
    v = fields["val"][v_idx]
    vr = fields["dr"][v_idx]
    vl = fields["dl"][v_idx]
    sn = ur - (u + vl) / r
    ss = vr - v / r + ul / r
    zeta = v / r + vr - ul / r
    return sn * sn + ss * ss - zeta * zeta


def kinetic_energy(fields, u_idx: int, v_idx: int) -> torch.Tensor:
    u = fields["val"][u_idx]
    v = fields["val"][v_idx]
    return 0.5 * (u * u + v * v)


def emanuel_potential_intensity(
    Tk_col, p_col, q_col, sst, Ck=1.2e-3, Cd=1.5e-3
):
    """Emanuel maximum potential intensity (E-MPI) of a sounding column
    (beyond-reference diagnostic; Emanuel 1986/1995, Bister & Emanuel
    1998 form):

        Vmax^2 = (Ck/Cd) * (Ts - To)/To * (k*_s - k_b)

    with Ts the sea-surface temperature, To the outflow temperature
    (taken as the column's coldest level — the standard tropopause
    proxy), k*_s the SATURATION enthalpy of air at the sea surface
    (Ts, surface pressure) and k_b the boundary-layer air enthalpy,
    k = Cp T + L_v q.  Inputs are profile arrays [nz] ordered
    bottom-up: temperature [K], pressure [hPa], vapor mixing ratio
    [kg/kg]; ``sst`` in K.  Returns (Vmax [m/s], To [K], disequilibrium
    k*_s - k_b [J/kg]).

    It quantifies how far a simulated Vmax sits from its theoretical
    ceiling.  NB axisymmetric models
    routinely overshoot E-MPI by tens of percent (superintensity:
    Persing & Montgomery 2003 measured up to ~50% in an axisymmetric
    RE87 core) because the theory neglects, among others, the eyewall
    supergradient flow the BL spins up — so simulated > E-MPI is a
    known regime, not an error; the diagnostic makes the overshoot a
    NUMBER.
    """
    Tk = np.asarray(Tk_col, np.float64)
    p = np.asarray(p_col, np.float64)
    q = np.asarray(q_col, np.float64)
    To = float(Tk.min())
    Ts = float(sst)
    # saturation enthalpy of sea-surface air at (Ts, surface pressure)
    q_star = float(td.q_sat_liquid(torch.tensor(Ts, dtype=torch.float64),
                                   torch.tensor(p[0], dtype=torch.float64)))
    Lv = float(td.L_v(Ts))
    k_star = td.Cpd * Ts + Lv * q_star
    # boundary-layer air enthalpy (lowest level)
    Lv_b = float(td.L_v(Tk[0]))
    k_b = td.Cpd * float(Tk[0]) + Lv_b * float(q[0])
    dk = max(k_star - k_b, 0.0)
    v2 = (Ck / Cd) * (Ts - To) / To * dk
    return float(np.sqrt(max(v2, 0.0))), To, dk
