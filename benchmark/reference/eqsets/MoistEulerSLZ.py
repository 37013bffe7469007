"""``MoistEulerSLZ`` (``scythe_tpu_torch/equations/sphere.py``) written for
the benchmark's reference from its equations: the moist compressible core
of ``MoistEulerRLZ`` (perturbation s, xi, mu against the reference column,
Ooyama warm rain, the AI2* vertical acoustics through the semi-implicit
option) on the SLZ shell, with the cylindrical metric terms replaced by the
spherical ones, and the condensation adjustment the port's step applies
after its update.

On the shell (phi latitude, lambda longitude, a the planet's radius; the
grid's slots are d/dphi and d/dlambda):

    advection      -(u / (a cos phi)) d/dlambda - (v / a) d/dphi - w d/dz
    divergence     u_lambda / (a cos phi) + v_phi / a - v tan(phi) / a + w_z
    Coriolis       f = 2 Omega sin(phi), curvature u tan(phi) / a:
                   u_t += (f + u tan(phi)/a) v - p_lambda / (a cos(phi) rho)
                   v_t -= (f + u tan(phi)/a) u + p_phi / (a rho)
    Laplacian      d2/dphi2 / a^2 + d2/dlambda2 / (a cos phi)^2
                   - tan(phi) d/dphi / a^2, each variable on its own (the
                   vector-Laplacian metric terms of the momentum are left
                   out, as in the port)

The diffusion: ``K`` on the horizontal Laplacian, ``K_v`` (default ``K``)
on d2/dz2, with ``options['smagorinsky']`` the capped Smagorinsky
viscosity (``smagorinsky_axes`` "rl": the horizontal-only closure, which
takes the two-term form); ``options['hyperdiffusion_k4']`` subtracts
K4 del^4, the horizontal Laplacian of every diffused variable taken through
the grid's analysis and synthesis and its Laplacian taken again, and
refuses a K4 whose diagonal del^4 rate passes 0.5 of the step (AB3's
real-axis limit is ~0.545).

Departures from the port: the refit calls the reference grid's own
``analysis`` and ``synthesis`` (the port calls the step's, which are the
grid's on one device); the guard's meridional spacing is pi a / rDim, as
the port's.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import microphysics as mp
from .. import thermodynamics as td
from .. import turbulence as tb
from ..equations import EqContext, EqResult, field_of, laplacian_mask, same_param, stack_tendencies

OPTIONS = frozenset({"sedimentation", "stiff_relaxation", "condensation", "condensation_tau",
                     "condensation_rate_cap", "smagorinsky", "smagorinsky_axes",
                     "hyperdiffusion_k4"})

# the droplet number (cm^-3) and radius (um) of the condensation rate
N_C, R_C = 100.0, 10.0


def horizontal_laplacian(val_phi, val_phiphi, val_lamlam, a, cosp, tanp):
    """The spherical surface Laplacian from the latitude and longitude slots."""
    aa = a * a
    return val_phiphi / aa + val_lamlam / (aa * cosp * cosp) - tanp * val_phi / aa


def del4_guard(k4, a, rdim, ts):
    """Refuse a K4 past the explicit limit: the diagonal two-grid mode's rate
    K4 (2 (pi / dx)^2)^2 ts, dx = pi a / rDim, must stay below 0.5."""
    dx = np.pi * float(a) / rdim
    rate = k4 * (2.0 * (np.pi / dx) ** 2) ** 2 * ts
    if rate > 0.5:
        raise ValueError(f"hyperdiffusion_k4: diagonal del^4 CFL {rate:.2f} > 0.5 "
                         f"(K4={k4:.2e}, dx_lat={dx / 1e3:.0f} km, ts={ts}); reduce K4 or ts")


def hyperdiffusion(horiz, grid, a, cosp, tanp):
    """del^4: ``horiz`` (the horizontal Laplacian of every variable) refit
    through the grid's analysis and synthesis, and its Laplacian."""
    f2 = grid.synthesis(grid.analysis(horiz))
    return horizontal_laplacian(f2["dr"], f2["drr"], f2["dll"], a, cosp, tanp)


def tendency(fields, ctx: EqContext) -> EqResult:
    """Vars: s xi mu u v w mu_c mu_r qss (u eastward, v northward, w up).
    physical_params: K, K_v (default K), Omega (default 7.292e-5)."""
    K = ctx.p("K")
    Omega = ctx.p("Omega", 7.292e-5)
    a = ctx.grid.params.sphere_radius
    rs = ctx.ref_state
    phi = ctx.coords["lat"]
    cosp, tanp = torch.cos(phi), torch.tan(phi)
    f_cor = 2.0 * Omega * torch.sin(phi)
    acos = a * cosp

    val, dp, dpp = fields["val"], fields["dr"], fields["drr"]
    dl, dll, dz, dzz = fields["dl"], fields["dll"], fields["dz"], fields["dzz"]
    s, xi, mu = val[0], val[1], val[2]
    u, v, w = val[3], val[4], val[5]
    mu_c, mu_r, qss = val[6], val[7], val[8]

    # the state from the perturbations and the reference column [1, 1, nz]
    col = {name: getattr(rs, name)[None, None, :, 0] for name in ("sbar", "xibar", "mubar",
                                                                  "mu_lbar")}
    sbar_z = rs.sbar[None, None, :, 1]
    q_v, rho_d, Tk, p = td.thermodynamic_tuple(s + col["sbar"], xi + col["xibar"],
                                               mu + col["mubar"])
    mu_fac = td.dmudq(mu + col["mubar"], q_v)
    q_c, q_r = td.ahyp(mu_c), td.ahyp(mu_r)
    q_l = q_c + q_r
    rho_t = rho_d * (1.0 + q_v + q_l)
    rhobar = td.dry_density(col["xibar"]) * (1.0 + td.ahyp(col["mubar"])
                                             + td.ahyp(col["mu_lbar"]))

    # advection of every variable, the reference column's own gradient on
    # s, xi and mu
    zero = torch.zeros_like(sbar_z)
    barz = torch.stack([sbar_z, rs.xibar[None, None, :, 1], rs.mubar[None, None, :, 1]]
                       + [zero] * 6)
    u3, v3, w3 = val[3:4], val[4:5], val[5:6]
    adv = -(u3 / acos) * dl - (v3 / a) * dp - w3 * dz - w3 * barz

    # diffusion of all but xi and qss
    mask = laplacian_mask(dp.dtype, dp.device)
    K_v = ctx.p("K_v", K)
    cs = float(ctx.options.get("smagorinsky", 0.0) or 0.0)
    ivd = bool(ctx.options.get("implicit_vdiff"))
    smag_h = str(ctx.options.get("smagorinsky_axes", "rlz")) == "rl"
    K_h, K_z, k_v = K, K_v, (K_v if ivd else None)
    if cs > 0.0:
        grads = [(dp[i] / a, dl[i] / acos, dz[i]) for i in (3, 4, 5)]
        k_t = tb.smagorinsky_viscosity(
            ctx.grid, ctx.ts, cs, *grads, dp.dtype,
            n2=None if smag_h else (td.GRAVITY / td.Cpd) * (dz[0] + sbar_z),
            split_vertical=ivd and not smag_h, horizontal_only=smag_h)
        if smag_h:
            K_h = K + k_t
        elif ivd:
            K_h, k_v = K + k_t[0], K_v + k_t[1]
        else:
            K_h, K_z = K + k_t, K_v + k_t
    horiz = horizontal_laplacian(dp, dpp, dll, a, cosp, tanp)
    if ivd:
        diff = mask * (K_h * horiz)
    elif same_param(K_v, K) and not smag_h:
        diff = mask * (K_h * (horiz + dzz))
    else:
        diff = mask * (K_h * horiz + K_z * dzz)
    k4 = float(ctx.options.get("hyperdiffusion_k4", 0.0) or 0.0)
    if k4 > 0.0:
        del4_guard(k4, a, ctx.grid.params.rDim, ctx.ts)
        diff = diff - mask * (k4 * hyperdiffusion(horiz, ctx.grid, a, cosp, tanp))

    # perturbation pressure gradients; the vertical one carries the exact
    # reference-gradient term (EqContext.vertical_pgf)
    coeffs = td.pressure_gradient_coeffs(Tk, rho_d, q_v)
    Ps, Pxi, Pqv = coeffs
    p_phi = Ps * dp[0] + Pxi * dp[1] + Pqv * (dp[2] / mu_fac)
    p_lam = Ps * dl[0] + Pxi * dl[1] + Pqv * (dl[2] / mu_fac)
    p_z = ctx.vertical_pgf(coeffs, dz[0], dz[1], dz[2] / mu_fac)

    # warm rain (the rainfall_test rates)
    cloudtau = ctx.stiff_rate(mp.invtau_condensation(Tk, p, N_C, R_C))
    raintau = ctx.stiff_rate(mp.rain_evaporation(q_r, rho_d, Tk, p))
    if ctx.options.get("condensation") == "diagnostic":
        # the phase change is the adjustment's after the update
        q_cond = torch.zeros_like(Tk)
        s_cond = torch.zeros_like(Tk)
        q_evap = raintau * torch.clamp(td.q_sat_liquid(Tk, p) - q_v, min=0.0)
    else:
        q_cond = ctx.cap_condensation(
            mp.q_condensation(qss, Tk, p, q_v, q_l, N_C, R_C, invtau=cloudtau))
        s_cond = mp.s_condensation(q_cond, Tk, rho_d, q_v, q_l, p)
        q_evap = -qss * raintau
    q_auto = mp.autoconversion(q_c, rho_d)
    q_coll = mp.collection(q_c, q_r, rho_d, Tk)
    fall = ctx.grid.column_flux_derivative(q_r * ctx.sedimentation(q_r, rho_d, Tk)) / rho_d
    Cm = (q_l * td.Cl) / (td.Cvd + q_v * td.Cvv + q_l * td.Cl)
    div3 = dl[3] / acos + dp[4] / a - v * tanp / a + dz[5]
    qss_src = (mp.dqsdp(Tk, p, rho_d, q_v, q_l)
               * ((u / acos) * p_lam + (v / a) * p_phi + w * (p_z - rhobar * td.GRAVITY))
               - qss * (cloudtau + raintau))
    curv = f_cor + u * tanp / a

    src = {
        0: s_cond + Cm * (td.Rd + q_v * td.Rv) * div3,
        1: -div3,
        2: mu_fac * (q_evap - q_cond),
        3: curv * v - p_lam / (acos * rho_t),
        4: -curv * u - p_phi / (a * rho_t),
        5: (-td.GRAVITY * (rho_t - rhobar) - p_z) / rho_t,
        6: ctx.dmudq_source(mu_c, q_c) * (q_cond - q_auto - q_coll),
        7: ctx.dmudq_source(mu_r, q_r) * (q_auto + q_coll - q_evap - fall),
        8: qss_src,
    }
    # the terms the AI2* corrector takes implicitly, and the histories of
    # mu's vapour and qss the condensation adjustment reads
    imp = {1: -dz[5], 2: q_v, 5: -(ctx.pxi_si() * dz[1]), 8: qss}
    nvars, sh, dt = ctx.grid.nvars, u.shape, u.dtype
    return EqResult(
        expdot=adv + diff + stack_tendencies(nvars, sh, dt, src),
        impdot=stack_tendencies(nvars, sh, dt, imp),
        k_v=field_of(k_v, sh, dt, u.device) if ivd else None,
    )


def after_update(var_np1, impdot, ctx: EqContext):
    return mp.condensation_adjustment(var_np1, impdot, ctx)
