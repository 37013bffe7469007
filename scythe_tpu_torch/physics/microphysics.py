"""Warm-rain (Ooyama 2001-style) microphysics (ref src/microphysics.jl), in
PyTorch.

The process rates, the post-step ``condensation_adjustment`` and the
Newton ``saturation_adjustment`` (a fixed nine passes with a converged mask,
as the JAX package's ``fori_loop``), elementwise on tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import condensation as cond_ops
from . import thermodynamics as td

_TINY = td._TINY


def q_condensation(qss, Tk, p, q_v, q_l, N_c, r_c, invtau=None):
    """(ref microphysics.jl:102-112).  ``invtau`` overrides the internal
    rate so callers can pass the stability-limited one
    (EqContext.stiff_rate) consistently with the qss relaxation term."""
    Q_s = Q_s_factor(Tk, p, q_v, q_l)
    q_cond = qss / (1.0 + Q_s)
    q_cond = torch.minimum(q_v, q_cond)
    q_cond = torch.maximum(-q_l, q_cond)
    if invtau is None:
        invtau = invtau_condensation(Tk, p, N_c, r_c)
    return q_cond * invtau


def s_condensation(q_cond, Tk, rho_d, q_v, q_l, p):
    """Entropy source of condensation (ref microphysics.jl:115-123).  The
    ratio e/sat_e is guarded, not e alone: in float32 the quotient of a
    tiny e underflows to 0 and log(0) would turn 0 * -inf into NaN."""
    Cm = (q_l * td.Cl) / (td.Cvd + q_v * td.Cvv + q_l * td.Cl)
    e = td.vapor_pressure(p, q_v)
    sat_e = td.sat_pressure_liquid_buck(Tk, p)
    ratio = torch.clamp(e / sat_e, min=_TINY)
    return q_cond * (
        (-td.L_v(Tk) * Cm) / Tk
        - td.Cl * torch.log(Tk / td.T_0)
        + td.Rv * torch.log(ratio)
    )


def Q_s_factor(Tk, p, q_v, q_l):
    e_s = td.sat_pressure_liquid_buck(Tk, p)
    dqsdT = td.sat_pressure_liquid_buck_dT(Tk, p) * td.Eps * p / (p - e_s) ** 2
    return td.L_v(Tk) * dqsdT / (td.Cpd + q_v * td.Cpv + q_l * td.Cl)


def dqsdp(Tk, p, rho_d, q_v, q_l):
    q_sat = td.q_sat_liquid(Tk, p)
    e_s = td.sat_pressure_liquid_buck(Tk, p)
    dqsdT = td.sat_pressure_liquid_buck_dT(Tk, p) * td.Eps * p / (p - e_s) ** 2
    return q_sat / (100.0 * (p - e_s)) - dqsdT / (
        rho_d * (td.Cpd + q_v * td.Cpv + q_l * td.Cl)
    )


def invtau_condensation(Tk, p, N_c, r_c):
    Dv = vapor_diffusity(Tk, p)
    return 4.0 * math.pi * Dv * N_c * (r_c * 1.0e-4)


def vapor_diffusity(Tk, p):
    """Pruppacher & Klett (1997); Tk in K, p in hPa, Dv in cm^2/s."""
    return 0.211 * (Tk / 273.15) ** 1.94 * (1013.25 / p)


def linear_saturation_adjustment(qss, Tk, p, q_v, q_l):
    """(ref microphysics.jl:85-100)."""
    q_sat = td.q_sat_liquid(Tk, p)
    Q_s = Q_s_factor(Tk, p, q_v, q_l)
    dq = (q_v - q_sat - qss) / (1.0 + Q_s)
    dq = torch.minimum(q_v, dq)
    dq = torch.maximum(-q_l, dq)
    return torch.where(q_v == 0.0, 0.0, dq)


def saturation_adjustment(s, xi, mu, mu_l, tol=1.0e-12):
    """Newton iteration to saturation (ref microphysics.jl:1-70); returns
    (dq, dT).  Nine passes; a point that has converged keeps its dq."""
    incr = 1.0e-6
    q_v, rho_d, Tk, p = td.thermodynamic_tuple(s, xi, mu)
    q_l = td.ahyp(mu_l)
    q_sat = td.q_sat_liquid(Tk, p)
    e_s = td.sat_pressure_liquid_buck(Tk, p)
    dqsdT = td.sat_pressure_liquid_buck_dT(Tk, p) * td.Eps * p / (p - e_s) ** 2
    cp = td.Cpd + q_v * td.Cpv + q_l * td.Cl
    dq = (q_sat - q_v) / (1.0 + td.L_v(Tk) * dqsdT / cp)
    SS0 = q_v - q_sat

    for _ in range(9):
        dq_up = dq + incr
        dT_up = -dq_up * td.L_v(Tk) / cp
        SS_up = (q_v + dq_up) - td.q_sat_liquid(Tk + dT_up, p)
        dT = -dq * td.L_v(Tk) / cp
        SS_dn = (q_v + dq) - td.q_sat_liquid(Tk + dT, p)
        dSSdq = (SS_up - SS_dn) / incr
        step = torch.where(torch.abs(dSSdq) > 0, SS_dn / dSSdq, 0.0)
        active = torch.abs(SS_dn) > tol
        dq = torch.where(active, dq - step, dq)

    # clamp to available water (ref microphysics.jl:52-63), in this order
    dq = torch.where(q_v + dq < 0.0, -q_v, dq)
    dq = torch.where(q_l - dq < 0.0, q_l, dq)
    dT = -dq * td.L_v(Tk) / cp
    zero = q_v == 0.0
    dq = torch.where(zero, 0.0, dq)
    dT = torch.where(zero, 0.0, dT)
    init_sat = torch.abs(SS0) < tol
    dq = torch.where(init_sat, 0.0, dq)
    dT = torch.where(init_sat, 0.0, dT)
    return dq, dT


def autoconversion(q_c, rho_d):
    """Ooyama (2001) (ref microphysics.jl:197-205)."""
    return torch.clamp(0.001 * (q_c - 0.001), min=0.0)


def f_ice(Tk):
    """(ref microphysics.jl:216-224)."""
    sech = 1.0 / torch.cosh((273.15 - Tk) / 5.0)
    return torch.where(Tk < 273.15, 0.2 + 0.8 * sech, 1.0)


def collection(q_c, q_r, rho_d, Tk):
    """(ref microphysics.jl:207-214)."""
    qr = torch.clamp(q_r, min=0.0)
    return torch.clamp(2.20 * q_c * qr**0.875 * f_ice(Tk), min=0.0)


def rain_evaporation(q_r, rho_d, Tk, p):
    """(ref microphysics.jl:226-238)."""
    e_s = td.sat_pressure_liquid_buck(Tk, p)
    rho_vs = e_s / (td.Rv * Tk)
    rho_r = torch.clamp(q_r * rho_d, min=0.0)
    q_evap = (f_ventilation(q_r, rho_d, Tk) * rho_r**0.525) / (
        1.0e4 * (2.03 * rho_vs + 3.337 / Tk)
    )
    return torch.clamp(q_evap, min=0.0)


def f_ventilation(q_r, rho_d, Tk):
    rho_r = torch.clamp(q_r * rho_d, min=0.0)
    return torch.clamp(1.6 + 30.39 * rho_r**0.2046 * f_ice(Tk) ** 1.5, min=0.0)


def sedimentation_formula(q_r, rho_d, Tk):
    """The reference's terminal-velocity expression verbatim
    (microphysics.jl:240-249): a negative magnitude clamped at zero."""
    rho_r = torch.clamp(q_r * rho_d, min=0.0)
    Vt = -14.164 * rho_r**0.1364 * torch.sqrt(td.rho_d0 / rho_d) * f_ice(Tk)
    return torch.clamp(Vt, min=0.0)


def sedimentation(q_r, rho_d, Tk):
    """Terminal velocity as the reference computes it (microphysics.jl:
    240-249): a negative magnitude clamped at zero, so always 0 (the quirk
    documented in scythe_tpu.physics.microphysics.sedimentation)."""
    return torch.zeros_like(q_r * rho_d * Tk)


def sedimentation_active(q_r, rho_d, Tk):
    """The reference formula without the sign clamp: a negative (downward)
    rain terminal velocity.  Opt-in via options['sedimentation']='active'."""
    rho_r = torch.clamp(q_r * rho_d, min=0.0)
    return -14.164 * rho_r**0.1364 * torch.sqrt(td.rho_d0 / rho_d) * f_ice(Tk)


def condensation_params(ctx) -> cond_ops.Params:
    """What the condensation adjustment takes from the context, as scalars,
    read once for the plain chain and the kernel alike: options['condensation']
    'diagnostic' (the rate-capped saturation adjustment, tau_r 1, the cap
    condensation_rate_cap x ts, the factor 1 - exp(-ts/condensation_tau)
    where the timescale is set) or the default (the reference's partial
    relaxation toward the qss-shifted saturation, tau_r 0.25); the source
    Jacobian (options['reference_quirks']: the raw dmudq); and the rows."""
    vi = ctx.var_index
    names = ctx.grid.params.vars
    diagnostic = ctx.options.get("condensation") == "diagnostic"
    cap, tau_factor = math.inf, None
    if diagnostic:
        cap = float(ctx.options.get("condensation_rate_cap", 2.0e-4)) * ctx.ts
        tau_c = float(ctx.options.get("condensation_tau", 0.0) or 0.0)
        if tau_c > 0.0:
            tau_factor = 1.0 - float(np.exp(-ctx.ts / tau_c))
    return cond_ops.Params(
        diagnostic=diagnostic,
        tau_r=1.0 if diagnostic else 0.25,
        cap=cap,
        tau_factor=tau_factor,
        quirks=bool(ctx.options.get("reference_quirks")),
        s=vi("s"), xi=vi("xi"), mu=vi("mu"),
        cloud=vi("mu_c" if "mu_c" in names else "mu_l"),
        mu_r=vi("mu_r") if "mu_r" in names else None,
        qss=vi("qss"),
    )


def condensation_adjustment(var_np1, impdot_n, ctx):
    """Post-step Euler adjustment toward saturation using the advected
    supersaturation (ref condensation_adjustment, microphysics.jl:139-195).

    ``var_np1``: [nvars, *spatial] with z last; uses vars s, xi, mu, mu_c
    (or mu_l), mu_r (optional), qss.  Returns the state with the s, mu and
    cloud rows adjusted and the others as they were, by
    ``ops.condensation.condensation_adjustment``: the plain chain below on
    the CPU, the kernel on a CUDA device (in place where neither autograd
    nor a functorch transform sees the call).
    """
    rs = ctx.ref_state
    return cond_ops.condensation_adjustment(var_np1, rs.sbar, rs.xibar, rs.mubar,
                                            condensation_params(ctx))


def condensation_adjustment_plain(var_np1, sbar, xibar, mubar, prm):
    """``condensation_adjustment`` in plain PyTorch, which autograd
    differentiates, with the reference columns sbar, xibar, mubar [nz, k]
    (read at [:, 0]): out of place, since the thermodynamics below keep
    views of ``var_np1`` for the backward, which a write into it would
    corrupt."""
    s = var_np1[prm.s]
    xi = var_np1[prm.xi]
    mu = var_np1[prm.mu]
    mu_c = var_np1[prm.cloud]
    qss = var_np1[prm.qss]

    mu_total = mu + mubar[None, :, 0]
    q_v, rho_d, Tk, p = td.thermodynamic_tuple(s + sbar[None, :, 0], xi + xibar[None, :, 0],
                                               mu_total)
    q_c = td.ahyp(mu_c)
    q_r = td.ahyp(var_np1[prm.mu_r]) if prm.mu_r is not None else torch.zeros_like(q_c)
    q_l = q_c + q_r
    q_sat = td.q_sat_liquid(Tk, p)
    Q_s = Q_s_factor(Tk, p, q_v, q_l)

    # options['condensation'] = 'diagnostic': the rate-capped saturation
    # adjustment of the JAX package (cap * ts per step, optional finite
    # timescale); default: the reference's partial relaxation toward the
    # qss-shifted saturation (tau_r = 0.25 per step)
    if prm.diagnostic:
        q_cond = (q_v - q_sat) / (1.0 + Q_s)
        if prm.tau_factor is not None:
            q_cond = q_cond * prm.tau_factor
        q_cond = torch.clamp(q_cond, -prm.cap, prm.cap)
    else:
        q_cond = (q_v - q_sat - qss) / (1.0 + Q_s)
    q_cond = torch.minimum(q_v, q_cond)
    q_cond = torch.maximum(-q_c, q_cond)  # restrict to condensate, not rain
    tau_r = prm.tau_r
    src = td.dmudq(mu_c, q_c) if prm.quirks else td.dmudq_source(mu_c, q_c)
    mu_new = mu - tau_r * td.dmudq(mu_total, q_v) * q_cond
    mu_c_new = mu_c + tau_r * src * q_cond
    s_new = s + tau_r * s_condensation(q_cond, Tk, rho_d, q_v, q_l, p)

    new = {prm.s: s_new, prm.mu: mu_new, prm.cloud: mu_c_new}
    return torch.stack([new.get(v, var_np1[v]) for v in range(var_np1.shape[0])])
