"""Frozen copy of ``scythe_tpu_torch/physics/thermodynamics.py`` for the benchmark's plain
reference (imports rewritten; it imports nothing of the port).

Moist thermodynamic state functions (ref src/thermodynamics.jl), in
PyTorch.

The functions of ``scythe_tpu.physics.thermodynamics``, elementwise on
tensors of any shape, dtype and device.  Inputs are tensors; where the
reference state is made on the host they are CPU float64 tensors
(``torch.from_numpy``), so no value leaves the host there.
Constants follow Emanuel (1994) as in the reference (thermodynamics.jl:1-32).
"""

from __future__ import annotations

import numpy as np
import torch

# Constants (ref thermodynamics.jl:1-16)
Rd = 287.04
Rv = 461.50
Eps = Rd / Rv
Cvd = 716.96
Cvv = 1410.0
Cpd = Cvd + Rd
Cpv = Cvv + Rv
Cl = 4186.0
Ci = 2106.0
GRAVITY = 9.81
gravity = GRAVITY
L_v0 = 2.501e6
T_0 = 273.16
p_0 = 1000.0
q0 = 1.0e-7

rho_d0 = 100.0 * p_0 / (T_0 * Rd)
_es_T0 = float(6.112 * np.exp(17.67 * (T_0 - 273.15) / ((T_0 - 273.15) + 243.5)))
rho_v0 = 100.0 * _es_T0 / (T_0 * Rv)

_TINY = 1.0e-37  # representable in float32, unlike 1e-300 (which would turn
# every clamp(x, min=_TINY) guard into a no-op on the f32 path)


def sat_pressure_liquid(Tk):
    Tc = Tk - 273.15
    return 6.112 * torch.exp(17.67 * Tc / (Tc + 243.5))


def sat_pressure_ice(Tk):
    Tc = Tk - 273.15
    return 6.112 * torch.exp(21.8745584 * Tc / (Tc + 265.49))


def L_v(Tk):
    return L_v0 + (Cpv - Cl) * (Tk - T_0)


def vapor_pressure(p, q_v):
    return (p * q_v) / (Eps + q_v)


def mixing_ratio(p, e):
    return (Eps * e) / (p - e)


def dewpoint(p, q_v):
    e = vapor_pressure(p, q_v)
    le = torch.log(e / 6.112)
    return 243.5 * le / (17.67 - le) + 273.15


def entropy(Tk, rho_d, q_v):
    """Moist entropy (ref thermodynamics.jl:46-58)."""
    qs = torch.clamp(q_v, min=_TINY)
    qfactor = torch.where(
        q_v != 0.0,
        q_v * (Rv * torch.log(qs * rho_d / rho_v0) - (L_v(T_0) / T_0)),
        0.0,
    )
    Cfactor = Cvd + q_v * Cvv
    return Cfactor * torch.log(Tk / T_0) - Rd * torch.log(rho_d / rho_d0) - qfactor


def vapor_entropy(Tk, rho_d, q_v):
    qs = torch.clamp(q_v, min=_TINY)
    return torch.where(
        q_v > 0.0,
        Cvv * torch.log(Tk / T_0) - Rv * torch.log(qs * rho_d / rho_v0) + L_v(T_0) / T_0,
        0.0,
    )


def temperature(s, rho_d, q_v):
    """Inverse of entropy at fixed (rho_d, q_v) (ref thermodynamics.jl:70-84)."""
    Cfactor = Cvd + q_v * Cvv
    qs = torch.clamp(q_v, min=_TINY)
    qfactor = torch.where(
        q_v != 0.0, (rho_d * qs / rho_v0) ** ((q_v * Rv) / Cfactor), 1.0
    )
    rhofactor = (rho_d / rho_d0) ** (Rd / Cfactor)
    Tfactor = torch.exp((s - (q_v * L_v(T_0) / T_0)) / Cfactor)
    return T_0 * Tfactor * rhofactor * qfactor


def pressure(s, rho_d, q_v):
    Tk = temperature(s, rho_d, q_v)
    return 0.01 * Rd * Tk * rho_d + 0.01 * Rv * Tk * rho_d * q_v


# Buck-formula temperature guard (see scythe_tpu.physics.thermodynamics):
# the fit has a pole near 15 K, so inputs are clipped to where it holds.
_T_SAT_MIN, _T_SAT_MAX = 100.0, 400.0


def sat_pressure_liquid_buck(Tk, phPa):
    """Buck (1981) with pressure enhancement (ref thermodynamics.jl:113-130)."""
    Tc = torch.clamp(Tk - 273.15, _T_SAT_MIN - 273.15, _T_SAT_MAX - 273.15)
    fw4 = 1.0 + 7.2e-4 + phPa * (3.20e-6 + 5.9e-10 * Tc**2)
    ew4 = 6.1121 * torch.exp((18.729 - Tc / 227.3) * Tc / (Tc + 257.87))
    return fw4 * ew4


def sat_pressure_liquid_buck_dT(Tk, phPa):
    """d/dT of the Buck formula (ref thermodynamics.jl:132-153)."""
    Tc = torch.clamp(Tk - 273.15, _T_SAT_MIN - 273.15, _T_SAT_MAX - 273.15)
    C = 5.9e-10
    fw4 = 1.0 + 7.2e-4 + phPa * (3.20e-6 + C * Tc**2)
    d_fw4 = 2.0 * phPa * C * Tc
    b, c, d = 18.729, 257.87, 227.3
    ew4 = 6.1121 * torch.exp((b - Tc / d) * Tc / (Tc + c))
    T1 = (d * b - 2.0 * Tc) * (d * (Tc + c)) - d * ((d * b * Tc) - Tc**2)
    T2 = (d * (Tc + c)) ** 2
    d_ew4 = ew4 * T1 / T2
    return ew4 * d_fw4 + fw4 * d_ew4


def sat_pressure_ice_buck(Tk, phPa):
    Tc = torch.clamp(Tk - 273.15, _T_SAT_MIN - 273.15, _T_SAT_MAX - 273.15)
    fi4 = 1.0 + 2.2e-4 + phPa * (3.83e-6 + 6.4e-10 * Tc**2)
    ei3 = 6.1115 * torch.exp((23.036 - Tc / 333.7) * Tc / (Tc + 279.82))
    return fi4 * ei3


def q_sat_liquid(Tk, phPa):
    ew = sat_pressure_liquid_buck(Tk, phPa)
    return Eps * ew / (phPa - ew)


def q_sat_ice(Tk, phPa):
    ei = sat_pressure_ice_buck(Tk, phPa)
    return Eps * ei / (phPa - ei)


def bhyp(q_v):
    """Hyperbolic compression of vapor (ref thermodynamics.jl:184-188)."""
    return 0.5 * ((q_v + q0) - q0 * q0 / (q_v + q0))


def ahyp(mu):
    """Inverse of bhyp, clipped at zero (ref thermodynamics.jl:190-198)."""
    return torch.where(mu < 0.0, 0.0, torch.sqrt(mu * mu + q0 * q0) + mu - q0)


def dmudq(mu, q_v):
    return ((q_v + q0) - mu) / (q_v + q0)


def dmudq_source(mu, q_v):
    """dmudq clamped at 2 for q->mu source-term conversions (the stability
    guard of scythe_tpu.physics.thermodynamics.dmudq_source)."""
    return torch.clamp(dmudq(mu, q_v), max=2.0)


def dry_density(xi):
    return rho_d0 * torch.exp(xi)


def log_dry_density(rho_d):
    return torch.log(rho_d / rho_d0)


def P_s(Tk, rho_d, q_v):
    Cfactor = Cvd + q_v * Cvv
    return Tk * ((rho_d * Rd) + (q_v * rho_d * Rv)) / Cfactor


def P_xi(Tk, rho_d, q_v):
    """Reproduces the reference expression verbatim, including its
    idiosyncratic (Rd + q_v*rho_d*Rv) factor (thermodynamics.jl:221-224)."""
    return (Rd + (q_v * rho_d * Rv)) * ((rho_d * Tk) + P_s(Tk, rho_d, q_v))


def P_xi_from_s(s, xi, mu):
    q_v, rho_d, Tk, p = thermodynamic_tuple(s, xi, mu)
    return P_xi(Tk, rho_d, q_v)


def P_qv(Tk, rho_d, q_v):
    qs = torch.clamp(q_v, min=_TINY)
    rho_v = qs * rho_d
    qfactor = (
        Rv * (1.0 + torch.log(rho_v / rho_v0))
        - Cvv * torch.log(Tk / T_0)
        - L_v(T_0) / T_0
    ) * P_s(Tk, rho_d, q_v)
    return torch.where(q_v != 0.0, rho_d * Rv * Tk + qfactor, 0.0)


def P_mu(Tk, rho_d, mu):
    q_v = ahyp(mu)
    return P_qv(Tk, rho_d, q_v) / dmudq(mu, q_v)


def pressure_gradient(Tk, rho_d, q_v, s_x, xi_x, qv_x):
    """(ref thermodynamics.jl:246-254)."""
    return (
        P_s(Tk, rho_d, q_v) * s_x
        + P_xi(Tk, rho_d, q_v) * xi_x
        + P_qv(Tk, rho_d, q_v) * qv_x
    )


def pressure_gradient_coeffs(Tk, rho_d, q_v):
    """(P_s, P_xi, P_qv) evaluated once for several directional gradients."""
    return P_s(Tk, rho_d, q_v), P_xi(Tk, rho_d, q_v), P_qv(Tk, rho_d, q_v)


def reference_pgf_columns(rs):
    """(qbar_z [nz], pgf_bar [nz]) for the exact perturbation-form vertical
    PGF: the corrected gradient is dpd_z + P(local)·bar_z - pgf_bar (see
    scythe_tpu.physics.thermodynamics.reference_pgf_columns)."""
    sbar, xibar, mubar = rs.sbar, rs.xibar, rs.mubar
    qbar_v, rhobar_d, Tbar, _ = thermodynamic_tuple(
        sbar[:, 0], xibar[:, 0], mubar[:, 0]
    )
    qbar_z = mubar[:, 1] / dmudq(mubar[:, 0], qbar_v)
    pgf_bar = pressure_gradient(
        Tbar, rhobar_d, qbar_v, sbar[:, 1], xibar[:, 1], qbar_z
    )
    return qbar_z, pgf_bar


def thermodynamic_tuple(s, xi, mu):
    """(q_v, rho_d, Tk, p) from prognostic (s, xi, mu)
    (ref thermodynamics.jl:260-269)."""
    q_v = ahyp(mu)
    rho_d = dry_density(xi)
    Tk = temperature(s, rho_d, q_v)
    pd = 0.01 * Rd * Tk * rho_d
    e = 0.01 * Rv * Tk * rho_d * q_v
    return q_v, rho_d, Tk, pd + e


def potential_temperature(s, xi, mu):
    q_v, rho_d, Tk, p = thermodynamic_tuple(s, xi, mu)
    return Tk * (p_0 / p) ** (Rd / Cpd)


def reversible_theta_e(s, xi, mu, mu_l=None):
    """``mu_l`` None means no liquid (the JAX package's default 0.0)."""
    q_v, rho_d, Tk, p = thermodynamic_tuple(s, xi, mu)
    q_l = ahyp(torch.zeros_like(mu) if mu_l is None else mu_l)
    q_t = q_v + q_l
    e = vapor_pressure(p, q_v)
    es = sat_pressure_liquid_buck(Tk, p)
    cp = Cpd + Cl * q_t
    theta_term = Tk * (p_0 / (p - e)) ** (Rd / cp)
    H_term = (e / es) ** ((-Rv * q_v) / cp)
    exp_term = torch.exp(L_v(Tk) * q_v / (cp * Tk))
    return theta_term * H_term * exp_term


def theta_rho(s, xi, mu, mu_l=None):
    """``mu_l`` None means no liquid (the JAX package's default 0.0)."""
    q_v, rho_d, Tk, p = thermodynamic_tuple(s, xi, mu)
    q_l = ahyp(torch.zeros_like(mu) if mu_l is None else mu_l)
    theta = potential_temperature(s, xi, mu)
    return theta * (1.0 + q_v / Eps) / (1.0 + q_v + q_l)


def on_host(fn, *arrays):
    """``fn`` of this module on float64 host data (numbers or numpy arrays,
    through CPU tensors), for set-up and diagnostics; numpy out, a tuple of
    arrays where ``fn`` returns a tuple."""
    out = fn(*(torch.from_numpy(np.array(a, np.float64)) for a in arrays))
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()
