"""Equation sets of the SL / SLZ spherical shells, in PyTorch.

The counterpart of ``scythe_tpu.equations.sphere``, term for term:

* ``ShallowWaterSphere``: the rotating-sphere shallow-water system in
  advective form (the Williamson et al. 1992 test suite), with optional
  Laplacian-style diffusion (physical_params['K']) and bottom topography
  (ctx.extras['hs_grad'], options['topography_file']);
* ``AdvectionSphere``: solid-body-rotation tracer advection (Williamson
  case 1) at angle ``alpha`` to the polar axis;
* ``MoistEulerSLZ``: the global 3-D moist compressible core, the spherical
  sibling of MoistEulerRLZ.

Slots on an SL/SLZ grid: dr = d/dphi (latitude), dl = d/dlambda
(longitude); metric factors divide by a cos(phi) at the point of use.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..physics import microphysics as mp
from ..physics import thermodynamics as td
from ..physics import turbulence as tb
from .common import (EqContext, EqResult, equation_set, field_of, laplacian_mask, same_param,
                     stack_tendencies)


@equation_set(geometry="SL")
def ShallowWaterSphere(fields, ctx: EqContext) -> EqResult:
    """Vars: h (fluid depth), u (eastward), v (northward).

        h_t = -U h_lam - V h_phi - h div
        u_t = -U u_lam - V u_phi + (f + u tan(phi)/a) v - g/(a cos) h_lam
        v_t = -U v_lam - V v_phi - (f + u tan(phi)/a) u - (g/a) h_phi
        div = u_lam/(a cos) + v_phi/a - v tan(phi)/a
        U = u/(a cos), V = v/a, f = 2 Omega sin(phi)
    """
    g = ctx.p("g", 9.80616)
    Omega = ctx.p("Omega", 7.292e-5)
    K = ctx.p("K", 0.0)
    a = ctx.grid.params.sphere_radius
    phi = ctx.coords["lat"]
    cosp = torch.cos(phi)
    tanp = torch.tan(phi)
    f_cor = 2.0 * Omega * torch.sin(phi)

    val, dp, dpp, dl, dll = (
        fields["val"],
        fields["dr"],
        fields["drr"],
        fields["dl"],
        fields["dll"],
    )
    h, u, v = val[0], val[1], val[2]
    U = u / (a * cosp)
    V = v / a

    div = dl[1] / (a * cosp) + dp[2] / a - v * tanp / a
    curv = f_cor + u * tanp / a

    exp = {}
    exp[0] = -U * dl[0] - V * dp[0] - h * div
    exp[1] = -U * dl[1] - V * dp[1] + curv * v - (g / (a * cosp)) * dl[0]
    exp[2] = -U * dl[2] - V * dp[2] - curv * u - (g / a) * dp[0]
    # bottom topography (Williamson case 5): h is the fluid depth, the
    # momentum PGF acts on the free surface h + h_s; hs_grad = [d/dphi,
    # d/dlambda] of the spectrally filtered h_s
    hs_grad = ctx.extras.get("hs_grad")
    if hs_grad is not None:
        exp[1] = exp[1] - (g / (a * cosp)) * hs_grad[1]
        exp[2] = exp[2] - (g / a) * hs_grad[0]
    if K > 0.0:
        aa = a * a
        for i in range(3):
            exp[i] = exp[i] + K * (
                dpp[i] / aa + dll[i] / (aa * cosp * cosp) - tanp * dp[i] / aa
            )
    return EqResult(expdot=stack_tendencies(ctx.grid.nvars, h.shape, h.dtype, exp))


@equation_set(geometry="SL")
def AdvectionSphere(fields, ctx: EqContext) -> EqResult:
    """Solid-body-rotation tracer advection (Williamson case 1): h advected
    by the prescribed wind at angle ``alpha`` to the polar axis (pi/2 sends
    it over both poles).

        u = u0 (cos(phi) cos(alpha) + sin(phi) cos(lambda) sin(alpha))
        v = -u0 sin(lambda) sin(alpha)

    Vars: h (u, v, if present, are left alone).  physical_params: u0 [m/s],
    alpha [rad].
    """
    u0 = ctx.p("u0")
    alpha = ctx.p("alpha", 0.0)
    a = ctx.grid.params.sphere_radius
    phi = ctx.coords["lat"]
    lam = ctx.coords["lon"]
    cosp = torch.cos(phi)
    u = u0 * (cosp * np.cos(alpha) + torch.sin(phi) * torch.cos(lam) * np.sin(alpha))
    v = -u0 * torch.sin(lam) * np.sin(alpha)
    dh = -(u / (a * cosp)) * fields["dl"][0] - (v / a) * fields["dr"][0]
    return EqResult(expdot=stack_tendencies(ctx.grid.nvars, dh.shape, dh.dtype, {0: dh}))


@equation_set(geometry="SLZ")
def MoistEulerSLZ(fields, ctx: EqContext) -> EqResult:
    """Global 3-D moist compressible core on the SLZ shell: MoistEulerRLZ's
    (s, xi, mu) perturbation thermodynamics, Ooyama warm rain and AI2*
    vertical acoustics with the cylindrical metric terms replaced by
    spherical ones (tan(phi)/a curvature, 1/(a cos(phi)) zonal metric,
    f = 2 Omega sin(phi)).

    Vars: s xi mu u v w mu_c mu_r qss  (u eastward, v northward, w up).
    physical_params: K, K_v (default K), Omega (default Earth's).  Options
    as MoistEulerRLZ's, and options['hyperdiffusion_k4'] (a horizontal
    del^4 from refitting the first Laplacian through the step's analysis and
    synthesis, with an explicit-stability guard; the refit is the step's
    ``hyperdiffusion`` stage, inside ``tendency``).  Two divergences from
    ``scythe_tpu/equations/sphere.py:248,256``, both about sharded runs: the
    guard takes the meridional spacing from the grid's global rDim, where
    the JAX package takes the field's rows (a shard's rows under
    sharding); and the refit goes through the step's own transforms
    (``EqContext.analysis`` / ``synthesis``: under sharding the sharded
    analysis and the shard's synthesis), where the JAX package calls the
    grid's, which a shard's grid cannot do.  On one device both are the
    same.
    """
    K = ctx.p("K")
    Omega = ctx.p("Omega", 7.292e-5)
    a = ctx.grid.params.sphere_radius
    rs = ctx.ref_state
    phi = ctx.coords["lat"]
    cosp = torch.cos(phi)
    tanp = torch.tan(phi)
    f_cor = 2.0 * Omega * torch.sin(phi)

    val, dp, dpp, dl, dll, dz, dzz = (
        fields["val"],
        fields["dr"],
        fields["drr"],
        fields["dl"],
        fields["dll"],
        fields["dz"],
        fields["dzz"],
    )
    s, xi, mu = val[0], val[1], val[2]
    u, v, w = val[3], val[4], val[5]
    mu_c, mu_r, qss = val[6], val[7], val[8]

    sbar_z = rs.sbar[None, None, :, 1]
    xibar_z = rs.xibar[None, None, :, 1]
    mubar_z = rs.mubar[None, None, :, 1]
    q_v, rho_d, Tk, p = td.thermodynamic_tuple(
        s + rs.sbar[None, None, :, 0],
        xi + rs.xibar[None, None, :, 0],
        mu + rs.mubar[None, None, :, 0],
    )
    mu_total = mu + rs.mubar[None, None, :, 0]
    q_c = td.ahyp(mu_c)
    q_r = td.ahyp(mu_r)
    q_l = q_c + q_r
    rho_t = rho_d * (1.0 + q_v + q_l)
    mu_fac = td.dmudq(mu_total, q_v)
    rhobar = td.dry_density(rs.xibar[None, None, :, 0]) * (
        1.0
        + td.ahyp(rs.mubar[None, None, :, 0])
        + td.ahyp(rs.mu_lbar[None, None, :, 0])
    )
    rho_p = rho_t - rhobar

    # advection + masked diffusion over the full [nvars, ...] tensors, in
    # the JAX package's association order ((adv + lap) + sources)
    u3, v3, w3 = val[3:4], val[4:5], val[5:6]
    zrow = torch.zeros_like(sbar_z)
    barz = torch.stack(
        [sbar_z, xibar_z, mubar_z, zrow, zrow, zrow, zrow, zrow, zrow]
    )
    adv_all = -(u3 / (a * cosp)) * dl - (v3 / a) * dp - w3 * dz - w3 * barz
    lap_mask = laplacian_mask(dp.dtype, dp.device)
    aa = a * a
    K_v_const = ctx.p("K_v", K)  # a traced parameter stays a tensor
    cs = float(ctx.options.get("smagorinsky", 0.0) or 0.0)
    ivd = bool(ctx.options.get("implicit_vdiff"))
    smag_h = str(ctx.options.get("smagorinsky_axes", "rlz")) == "rl"
    K_eff, Kz_eff, k_v = K, K_v_const, (K_v_const if ivd else None)
    if cs > 0.0:
        acl = a * cosp
        k_t = tb.smagorinsky_viscosity(
            ctx.grid, ctx.ts, cs,
            (dp[3] / a, dl[3] / acl, dz[3]),
            (dp[4] / a, dl[4] / acl, dz[4]),
            (dp[5] / a, dl[5] / acl, dz[5]), dp.dtype,
            n2=None if smag_h else (td.GRAVITY / td.Cpd) * (dz[0] + sbar_z),
            split_vertical=ivd and not smag_h,
            horizontal_only=smag_h,
        )
        if smag_h:
            K_eff = K + k_t
        elif ivd:
            K_eff, k_v = K + k_t[0], K_v_const + k_t[1]
        else:
            K_eff, Kz_eff = K + k_t, K_v_const + k_t
    horiz = dpp / aa + dll / (aa * cosp * cosp) - tanp * dp / aa
    if ivd:
        lap_all = lap_mask * (K_eff * horiz)
    elif same_param(K_v_const, K) and not smag_h:
        lap_all = lap_mask * (K_eff * (horiz + dzz))
    else:
        lap_all = lap_mask * (K_eff * horiz + Kz_eff * dzz)
    k4 = float(ctx.options.get("hyperdiffusion_k4", 0.0) or 0.0)
    if k4 > 0.0:
        # diagonal 2-grid modes see 4x the 1-D del^4 rate; the AB3
        # real-axis limit is ~0.545, so refuse a K4 past 0.5
        dx_lat = np.pi * float(a) / ctx.grid.params.rDim
        cfl4 = k4 * (2.0 * (np.pi / dx_lat) ** 2) ** 2 * ctx.ts
        if cfl4 > 0.5:
            raise ValueError(
                f"hyperdiffusion_k4: diagonal del^4 CFL {cfl4:.2f} > 0.5 "
                f"(K4={k4:.2e}, dx_lat={dx_lat/1e3:.0f} km, ts={ctx.ts}); "
                "reduce K4 or ts"
            )
        with trace.stage("hyperdiffusion"):
            f2 = ctx.synthesis(ctx.analysis(horiz))
            horiz2 = (
                f2["drr"] / aa
                + f2["dll"] / (aa * cosp * cosp)
                - tanp * f2["dr"] / aa
            )
            lap_all = lap_all - lap_mask * (k4 * horiz2)

    # perturbation pressure gradients in all three directions; the vertical
    # carries the exact reference-gradient cross term (EqContext.vertical_pgf)
    coeffs = td.pressure_gradient_coeffs(Tk, rho_d, q_v)
    Ps, Pxi, Pqv = coeffs
    dpd_phi = Ps * dp[0] + Pxi * dp[1] + Pqv * (dp[2] / mu_fac)
    dpd_lam = Ps * dl[0] + Pxi * dl[1] + Pqv * (dl[2] / mu_fac)
    dpd_z = ctx.vertical_pgf(coeffs, dz[0], dz[1], dz[2] / mu_fac)

    N_c, r_c = 100.0, 10.0
    cloudtau = ctx.stiff_rate(mp.invtau_condensation(Tk, p, N_c, r_c))
    raintau = ctx.stiff_rate(mp.rain_evaporation(q_r, rho_d, Tk, p))
    q_cond = mp.q_condensation(qss, Tk, p, q_v, q_l, N_c, r_c, invtau=cloudtau)
    q_cond = ctx.cap_condensation(q_cond)
    s_cond = mp.s_condensation(q_cond, Tk, rho_d, q_v, q_l, p)
    q_evap = -qss * raintau
    if ctx.options.get("condensation") == "diagnostic":
        # phase change moves to the post-step adjustment; rain evaporation
        # takes the Kessler-style subsaturation form
        q_cond = torch.zeros_like(Tk)
        s_cond = torch.zeros_like(Tk)
        q_evap = raintau * torch.clamp(td.q_sat_liquid(Tk, p) - q_v, min=0.0)
    q_auto = mp.autoconversion(q_c, rho_d)
    q_coll = mp.collection(q_c, q_r, rho_d, Tk)
    Vt = ctx.sedimentation(q_r, rho_d, Tk)
    Vt_flux = ctx.grid.column_flux_derivative(q_r * Vt) / rho_d
    Cm = (q_l * td.Cl) / (td.Cvd + q_v * td.Cvv + q_l * td.Cl)
    div3 = dl[3] / (a * cosp) + dp[4] / a - v * tanp / a + dz[5]
    s_div = Cm * (td.Rd + q_v * td.Rv) * div3
    qss_cond = (
        mp.dqsdp(Tk, p, rho_d, q_v, q_l)
        * (
            (u / (a * cosp)) * dpd_lam
            + (v / a) * dpd_phi
            + w * (dpd_z - rhobar * td.GRAVITY)
        )
        - qss * (cloudtau + raintau)
    )
    curv = f_cor + u * tanp / a

    nvars = ctx.grid.nvars
    sh, dt = u.shape, u.dtype
    extra, imp = {}, {}
    extra[0] = s_cond + s_div
    extra[1] = -div3
    imp[1] = -dz[5]
    extra[2] = mu_fac * (q_evap - q_cond)
    imp[2] = q_v
    # momentum diffusion is the component-wise scalar Laplacian, as in the
    # JAX package (the vector-Laplacian metric terms are left out)
    extra[3] = curv * v - dpd_lam / (a * cosp * rho_t)
    extra[4] = -curv * u - dpd_phi / (a * rho_t)
    extra[5] = ((-td.GRAVITY * rho_p) - dpd_z) / rho_t
    imp[5] = -(ctx.pxi_si() * dz[1])
    extra[6] = ctx.dmudq_source(mu_c, q_c) * (q_cond - q_auto - q_coll)
    extra[7] = ctx.dmudq_source(mu_r, q_r) * (
        q_auto + q_coll - q_evap - Vt_flux
    )
    extra[8] = qss_cond
    imp[8] = qss
    return EqResult(
        expdot=adv_all + lap_all + stack_tendencies(nvars, sh, dt, extra),
        impdot=stack_tendencies(nvars, sh, dt, imp),
        k_v=(
            field_of(k_v, sh, dt, u.device)
            if ivd else None
        ),
    )
