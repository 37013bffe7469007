"""Idealized / test equation sets (ref src/testModels.jl), in PyTorch.

The counterpart of ``scythe_tpu.equations.test_models``, term for term:
linear advection on the four grids, the compressible Euler family
(Euler_test, BF02_test, rainfall_test) in (s, xi, mu) perturbation form,
``MoistEulerRLZ`` and ``MoistEulerXYZ``.
"""

from __future__ import annotations

import torch

from ..physics import microphysics as mp
from ..physics import thermodynamics as td
from ..physics import turbulence as tb
from .common import EqContext, EqResult, equation_set, same_param, stack_tendencies


@equation_set(geometry="R")
def LinearAdvection1D(fields, ctx: EqContext) -> EqResult:
    """u_t = -c0 u_r + K u_rr (ref testModels.jl:1-20)."""
    c0, K = ctx.p("c_0"), ctx.p("K")
    expdot = -(c0 * fields["dr"]) + K * fields["drr"]
    return EqResult(expdot=expdot)


@equation_set(geometry="RZ")
def LinearAdvectionRZ(fields, ctx: EqContext) -> EqResult:
    """Advection of h by prescribed (u, w) + diffusion with cylindrical
    term (ref testModels.jl:22-45)."""
    K = ctx.p("K")
    r = ctx.coords["r"]
    val, dr, drr, dz, dzz = (
        fields["val"],
        fields["dr"],
        fields["drr"],
        fields["dz"],
        fields["dzz"],
    )
    h_r, h_rr, h_z, h_zz = dr[0], drr[0], dz[0], dzz[0]
    u, w = val[1], val[3]
    dh = (-u * h_r) + (-w * h_z) + K * ((h_r / r) + h_rr + h_zz)
    return EqResult(
        expdot=stack_tendencies(ctx.grid.nvars, dh.shape, dh.dtype, {0: dh})
    )


@equation_set(geometry="RL")
def LinearAdvectionRL(fields, ctx: EqContext) -> EqResult:
    """Polar advection of h by (u, v), optional diffusion
    (ref testModels.jl:47-73)."""
    K = ctx.p("K")
    r = ctx.coords["r"]
    h_r, h_l = fields["dr"][0], fields["dl"][0]
    u, v = fields["val"][1], fields["val"][2]
    dh = (-u * h_r) - v * (h_l / r)
    if K > 0.0:
        h_rr, h_ll = fields["drr"][0], fields["dll"][0]
        dh = dh + K * ((h_r / r) + h_rr + (h_ll / (r * r)))
    return EqResult(
        expdot=stack_tendencies(ctx.grid.nvars, dh.shape, dh.dtype, {0: dh})
    )


@equation_set(geometry="RLZ")
def LinearAdvectionRLZ(fields, ctx: EqContext) -> EqResult:
    """3-D advection (no z-advection term, matching the reference;
    testModels.jl:75-98)."""
    K = ctx.p("K")
    r = ctx.coords["r"]
    h_r, h_rr = fields["dr"][0], fields["drr"][0]
    h_l, h_ll = fields["dl"][0], fields["dll"][0]
    u, v = fields["val"][1], fields["val"][2]
    dh = (-u * h_r) - v * (h_l / r) + K * ((h_r / r) + h_rr + (h_ll / (r * r)))
    return EqResult(
        expdot=stack_tendencies(ctx.grid.nvars, dh.shape, dh.dtype, {0: dh})
    )


# ----------------------------------------------------------------------
# Compressible Euler family (RZ), perturbation form vs a hydrostatic
# reference state: s (entropy'), xi (log dry density'), mu (bhyp vapor'),
# u, w (ref testModels.jl:100-215).


def _euler_core(fields, ctx: EqContext, extra_vars: int):
    """Shared setup for Euler_test/BF02_test/rainfall_test."""
    rs = ctx.ref_state
    val, dx, dxx, dz, dzz = (
        fields["val"],
        fields["dr"],
        fields["drr"],
        fields["dz"],
        fields["dzz"],
    )
    s, xi, mu, u, w = val[0], val[1], val[2], val[3], val[4]
    # reference-state columns broadcast over r: [1, nz]
    sbar_z = rs.sbar[None, :, 1]
    xibar_z = rs.xibar[None, :, 1]
    mubar_z = rs.mubar[None, :, 1]
    q_v, rho_d, Tk, p = td.thermodynamic_tuple(
        s + rs.sbar[None, :, 0], xi + rs.xibar[None, :, 0], mu + rs.mubar[None, :, 0]
    )
    return dict(
        val=val,
        dx=dx,
        dxx=dxx,
        dz=dz,
        dzz=dzz,
        s=s,
        xi=xi,
        mu=mu,
        u=u,
        w=w,
        sbar_z=sbar_z,
        xibar_z=xibar_z,
        mubar_z=mubar_z,
        q_v=q_v,
        rho_d=rho_d,
        Tk=Tk,
        p=p,
        mubar0=rs.mubar[None, :, 0],
        xibar0=rs.xibar[None, :, 0],
        pxi_bar=ctx.pxi_si(),
    )


@equation_set(geometry="RZ")
def Euler_test(fields, ctx: EqContext) -> EqResult:
    """Dry/moist compressible Euler benchmark (ref testModels.jl:100-215)."""
    K = ctx.p("K")
    c = _euler_core(fields, ctx, 0)
    dx, dxx, dz, dzz = c["dx"], c["dxx"], c["dz"], c["dzz"]
    u, w = c["u"], c["w"]
    q_v, rho_d, Tk = c["q_v"], c["rho_d"], c["Tk"]
    mu_total = c["mu"] + c["mubar0"]
    rho_t = rho_d * (1.0 + q_v)
    mu_fac = td.dmudq(mu_total, q_v)
    qvp_x = dx[2] / mu_fac
    qvp_z = dz[2] / mu_fac
    rhobar = td.dry_density(c["xibar0"]) * (1.0 + td.ahyp(c["mubar0"]))
    rho_p = rho_t - rhobar

    nvars = ctx.grid.nvars
    sh, dt = u.shape, u.dtype
    exp = {}
    imp = {}
    # s
    exp[0] = (-u * dx[0]) + (-w * (dz[0] + c["sbar_z"])) + K * (dxx[0] + dzz[0])
    # xi
    adv = (-u * dx[1]) + (-w * (dz[1] + c["xibar_z"]))
    exp[1] = adv - dx[3] - dz[4]
    imp[1] = -dz[4]
    # mu
    exp[2] = (-u * dx[2]) + (-w * (dz[2] + c["mubar_z"])) + K * (dxx[2] + dzz[2])
    # u
    coeffs = td.pressure_gradient_coeffs(Tk, rho_d, q_v)
    Ps, Pxi, Pqv = coeffs
    pgf_x = (Ps * dx[0] + Pxi * dx[1] + Pqv * qvp_x) / rho_t
    exp[3] = (-u * dx[3]) + (-w * dz[3]) - pgf_x + K * (dxx[3] + dzz[3])
    # w: reference-faithful perturbation PGF by default;
    # options['exact_vertical_pgf'] adds the reference-gradient cross
    # term (ctx.vertical_pgf docstring for the validation status)
    pgf_z = ctx.vertical_pgf(coeffs, dz[0], dz[1], qvp_z,
                             default_exact=False) / rho_t
    exp[4] = (
        (-u * dx[4])
        + (-w * dz[4])
        - (td.GRAVITY * rho_p / rho_t)
        - pgf_z
        + K * (dxx[4] + dzz[4])
    )
    imp[4] = -(c["pxi_bar"] * dz[1])
    return EqResult(
        expdot=stack_tendencies(nvars, sh, dt, exp),
        impdot=stack_tendencies(nvars, sh, dt, imp),
    )


@equation_set(geometry="RZ")
def BF02_test(fields, ctx: EqContext) -> EqResult:
    """Bryan & Fritsch-style moist bubble with prognostic supersaturation
    (ref testModels.jl:217-385).  Vars: s xi mu u w mu_l qss."""
    K = ctx.p("K")
    rs = ctx.ref_state
    c = _euler_core(fields, ctx, 2)
    dx, dxx, dz, dzz = c["dx"], c["dxx"], c["dz"], c["dzz"]
    u, w = c["u"], c["w"]
    q_v, rho_d, Tk, p = c["q_v"], c["rho_d"], c["Tk"], c["p"]
    mu_total = c["mu"] + c["mubar0"]
    mu_l = c["val"][5]
    qss = c["val"][6]
    q_l = td.ahyp(mu_l + rs.mu_lbar[None, :, 0])
    rho_t = rho_d * (1.0 + q_v + q_l)
    mu_fac = td.dmudq(mu_total, q_v)
    qvp_x = dx[2] / mu_fac
    qvp_z = dz[2] / mu_fac
    rhobar = td.dry_density(c["xibar0"]) * (1.0 + td.ahyp(c["mubar0"]))
    if ctx.options.get("exact_vertical_pgf"):
        # exact-PGF pairing: the BASE liquid loading belongs in the base
        # density.  Without it a cloudy reference column (mu_lbar > 0)
        # carries a permanent -g rhobar_d q_lbar body force (measured
        # 0.19 m/s^2 on the BF02 column; exactly balanced, 2e-15, with
        # the liquid included) — the faithful form absorbs it into a
        # static re-adjustment, the exact form must not.
        rhobar = td.dry_density(c["xibar0"]) * (
            1.0 + td.ahyp(c["mubar0"]) + td.ahyp(rs.mu_lbar[None, :, 0])
        )
    rho_p = rho_t - rhobar
    coeffs = td.pressure_gradient_coeffs(Tk, rho_d, q_v)
    Ps, Pxi, Pqv = coeffs
    dpdx = Ps * dx[0] + Pxi * dx[1] + Pqv * qvp_x
    dpdz = ctx.vertical_pgf(coeffs, dz[0], dz[1], qvp_z,
                            default_exact=False)

    # entropy divergence forcing + condensation (ref testModels.jl:300-320)
    Cm = (q_l * td.Cl) / (td.Cvd + q_v * td.Cvv + q_l * td.Cl)
    s_div = Cm * (td.Rd + q_v * td.Rv) * (dx[3] + dz[4])
    N_c, r_c = 500.0, 10.0
    invtau = ctx.stiff_rate(mp.invtau_condensation(Tk, p, N_c, r_c))
    q_cond = mp.q_condensation(qss, Tk, p, q_v, q_l, N_c, r_c, invtau=invtau)
    s_cond = mp.s_condensation(q_cond, Tk, rho_d, q_v, q_l, p)
    if ctx.options.get("condensation") == "diagnostic":
        # full saturation adjustment replaces the prognostic-qss source
        q_cond = torch.zeros_like(Tk)
        s_cond = torch.zeros_like(Tk)
    qss_cond = (
        mp.dqsdp(Tk, p, rho_d, q_v, q_l)
        * ((u * dpdx) + (w * (dpdz - rhobar * td.GRAVITY)))
        - qss * invtau
    )

    nvars = ctx.grid.nvars
    sh, dt = u.shape, u.dtype
    exp, imp = {}, {}
    exp[0] = (
        (-u * dx[0]) + (-w * (dz[0] + c["sbar_z"])) + s_cond + s_div + K * (dxx[0] + dzz[0])
    )
    exp[1] = (-u * dx[1]) + (-w * (dz[1] + c["xibar_z"])) - dx[3] - dz[4]
    imp[1] = -dz[4]
    exp[2] = (
        (-u * dx[2])
        + (-w * (dz[2] + c["mubar_z"]))
        - q_cond * mu_fac
        + K * (dxx[2] + dzz[2])
    )
    imp[2] = q_v  # storage slot consumed by condensation_adjustment (ref)
    exp[3] = (-u * dx[3]) + (-w * dz[3]) - dpdx / rho_t + K * (dxx[3] + dzz[3])
    exp[4] = (
        (-u * dx[4])
        + (-w * dz[4])
        + ((-td.GRAVITY * rho_p) - dpdz) / rho_t
        + K * (dxx[4] + dzz[4])
    )
    imp[4] = -(c["pxi_bar"] * dz[1])
    exp[5] = (
        (-u * dx[5])
        + (-w * (dz[5] + rs.mu_lbar[None, :, 1]))
        + q_cond * ctx.dmudq_source(mu_l, q_l)
        + K * (dxx[5] + dzz[5])
    )
    exp[6] = (-u * dx[6]) + (-w * dz[6]) + qss_cond
    imp[6] = qss
    return EqResult(
        expdot=stack_tendencies(nvars, sh, dt, exp),
        impdot=stack_tendencies(nvars, sh, dt, imp),
    )


@equation_set(geometry="RZ")
def rainfall_test(fields, ctx: EqContext) -> EqResult:
    """Full warm-rain benchmark (ref testModels.jl:387-585).
    Vars: s xi mu u w mu_c mu_r qss."""
    K = ctx.p("K")
    rs = ctx.ref_state
    c = _euler_core(fields, ctx, 3)
    dx, dxx, dz, dzz = c["dx"], c["dxx"], c["dz"], c["dzz"]
    u, w = c["u"], c["w"]
    q_v, rho_d, Tk, p = c["q_v"], c["rho_d"], c["Tk"], c["p"]
    mu_total = c["mu"] + c["mubar0"]
    mu_c, mu_r, qss = c["val"][5], c["val"][6], c["val"][7]
    q_c = td.ahyp(mu_c)
    q_r = td.ahyp(mu_r)
    q_l = q_c + q_r
    q_t = q_v + q_l
    rho_t = rho_d * (1.0 + q_t)
    mu_fac = td.dmudq(mu_total, q_v)
    qvp_x = dx[2] / mu_fac
    qvp_z = dz[2] / mu_fac
    rhobar = td.dry_density(c["xibar0"]) * (1.0 + td.ahyp(c["mubar0"]))
    if ctx.options.get("exact_vertical_pgf"):
        # exact-PGF pairing: the BASE liquid loading belongs in the base
        # density.  Without it a cloudy reference column (mu_lbar > 0)
        # carries a permanent -g rhobar_d q_lbar body force (measured
        # 0.19 m/s^2 on the BF02 column; exactly balanced, 2e-15, with
        # the liquid included) — the faithful form absorbs it into a
        # static re-adjustment, the exact form must not.
        rhobar = td.dry_density(c["xibar0"]) * (
            1.0 + td.ahyp(c["mubar0"]) + td.ahyp(rs.mu_lbar[None, :, 0])
        )
    rho_p = rho_t - rhobar
    coeffs = td.pressure_gradient_coeffs(Tk, rho_d, q_v)
    Ps, Pxi, Pqv = coeffs
    dpdx = Ps * dx[0] + Pxi * dx[1] + Pqv * qvp_x
    dpdz = ctx.vertical_pgf(coeffs, dz[0], dz[1], qvp_z,
                            default_exact=False)

    Cm = (q_l * td.Cl) / (td.Cvd + q_v * td.Cvv + q_l * td.Cl)
    s_div = Cm * (td.Rd + q_v * td.Rv) * (dx[3] + dz[4])
    N_c, r_c = 100.0, 10.0
    cloudtau = ctx.stiff_rate(mp.invtau_condensation(Tk, p, N_c, r_c))
    raintau = ctx.stiff_rate(mp.rain_evaporation(q_r, rho_d, Tk, p))
    q_cond = mp.q_condensation(qss, Tk, p, q_v, q_l, N_c, r_c, invtau=cloudtau)
    q_cond = ctx.cap_condensation(q_cond)
    s_cond = mp.s_condensation(q_cond, Tk, rho_d, q_v, q_l, p)
    q_evap = -qss * raintau
    if ctx.options.get("condensation") == "diagnostic":
        # phase change handled by the post-step full saturation adjustment
        # (condensation_adjustment, same option); rain evaporation becomes
        # the Kessler-style subsaturation form.  s needs no extra source:
        # s is moist entropy, conserved under phase change up to the
        # irreversible correction the adjustment applies.
        q_cond = torch.zeros_like(Tk)
        s_cond = torch.zeros_like(Tk)
        q_evap = raintau * torch.clamp(td.q_sat_liquid(Tk, p) - q_v, min=0.0)
    qss_cond = (
        mp.dqsdp(Tk, p, rho_d, q_v, q_l)
        * ((u * dpdx) + (w * (dpdz - rhobar * td.GRAVITY)))
        - qss * (cloudtau + raintau)
    )
    q_auto = mp.autoconversion(q_c, rho_d)
    q_coll = mp.collection(q_c, q_r, rho_d, Tk)
    Vt = ctx.sedimentation(q_r, rho_d, Tk)
    # flux divergence of falling precipitation via a Chebyshev column
    # derivative (ref testModels.jl:521-528)
    Vt_flux = ctx.grid.column_flux_derivative(q_r * Vt) / rho_d

    nvars = ctx.grid.nvars
    sh, dt = u.shape, u.dtype
    exp, imp = {}, {}
    exp[0] = (
        (-u * dx[0]) + (-w * (dz[0] + c["sbar_z"])) + s_cond + s_div + K * (dxx[0] + dzz[0])
    )
    exp[1] = (-u * dx[1]) + (-w * (dz[1] + c["xibar_z"])) - dx[3] - dz[4]
    imp[1] = -dz[4]
    exp[2] = (
        (-u * dx[2])
        + (-w * (dz[2] + c["mubar_z"]))
        + mu_fac * (q_evap - q_cond)
        + K * (dxx[2] + dzz[2])
    )
    imp[2] = q_v
    exp[3] = (-u * dx[3]) + (-w * dz[3]) - dpdx / rho_t + K * (dxx[3] + dzz[3])
    exp[4] = (
        (-u * dx[4])
        + (-w * dz[4])
        + ((-td.GRAVITY * rho_p) - dpdz) / rho_t
        + K * (dxx[4] + dzz[4])
    )
    imp[4] = -(c["pxi_bar"] * dz[1])
    exp[5] = (
        (-u * dx[5])
        + (-w * dz[5])
        + ctx.dmudq_source(mu_c, q_c) * (q_cond - q_auto - q_coll)
        + K * (dxx[5] + dzz[5])
    )
    exp[6] = (
        (-u * dx[6])
        + (-w * dz[6])
        + ctx.dmudq_source(mu_r, q_r) * (q_auto + q_coll - q_evap - Vt_flux)
        + K * (dxx[6] + dzz[6])
    )
    exp[7] = (-u * dx[7]) + (-w * dz[7]) + qss_cond
    imp[7] = qss
    return EqResult(
        expdot=stack_tendencies(nvars, sh, dt, exp),
        impdot=stack_tendencies(nvars, sh, dt, imp),
    )


@equation_set(geometry="RLZ")
def MoistEulerRLZ(fields, ctx: EqContext) -> EqResult:
    """Full 3-D cylindrical moist compressible Euler core with warm rain:
    the perturbation thermodynamics (s, xi, mu vs a hydrostatic reference
    state) and Ooyama warm-rain microphysics of the reference's 2-D slab
    sets on the full cylinder, term for term as
    ``scythe_tpu.equations.test_models.MoistEulerRLZ``.

    Vars: s xi mu u v w mu_c mu_r qss  (u radial, v tangential, w vertical).
    With options['smagorinsky'] = Cs the diffusivity takes the capped
    Smagorinsky closure (physics/turbulence.py); with
    options['implicit_vdiff'] the vertical K dzz term leaves the explicit
    tendency and the vertical diffusivity is returned as ``EqResult.k_v``
    for the backward-Euler column solve (model.build_implicit_vdiff).
    """
    K = ctx.p("K")
    f_cor = ctx.p("f", 0.0)
    rs = ctx.ref_state
    r = ctx.coords["r"]
    val, dr, drr, dl, dz, dzz = (
        fields["val"],
        fields["dr"],
        fields["drr"],
        fields["dl"],
        fields["dz"],
        fields["dzz"],
    )
    dll = fields["dll"]
    s, xi, mu = val[0], val[1], val[2]
    u, v, w = val[3], val[4], val[5]
    mu_c, mu_r, qss = val[6], val[7], val[8]

    # reference columns [1, 1, nz] against the z-last [r, l, z] fields
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
    adv_all = -u3 * dr - (v3 / r) * dl - w3 * dz - w3 * barz
    lap_mask = torch.tensor(
        [1.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0],
        dtype=dr.dtype, device=dr.device,
    )[:, None, None, None]
    # physical_params['K_v']: separate constant vertical diffusivity
    K_v_const = ctx.p("K_v", K)  # a traced parameter stays a tensor
    cs = float(ctx.options.get("smagorinsky", 0.0) or 0.0)
    ivd = bool(ctx.options.get("implicit_vdiff"))
    # options['smagorinsky_axes'] = 'rl': the horizontal-only closure; the
    # JAX package picks the two-term Laplacian form whenever it is 'rl',
    # even with the closure off
    smag_h = str(ctx.options.get("smagorinsky_axes", "rlz")) == "rl"
    K_eff, Kz_eff, k_v = K, K_v_const, (K_v_const if ivd else None)
    if cs > 0.0:
        k_t = tb.smagorinsky_viscosity(
            ctx.grid, ctx.ts, cs,
            (dr[3], dl[3] / r, dz[3]), (dr[4], dl[4] / r, dz[4]),
            (dr[5], dl[5] / r, dz[5]), dr.dtype,
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
    horiz = drr + dr / r + dll / (r * r)
    if ivd:
        lap_all = lap_mask * (K_eff * horiz)
    elif same_param(K_v_const, K) and not smag_h:
        lap_all = lap_mask * (K_eff * (horiz + dzz))
    else:
        lap_all = lap_mask * (K_eff * horiz + Kz_eff * dzz)

    # pressure gradients (perturbation form; the vertical carries the exact
    # reference-gradient cross term, EqContext.vertical_pgf)
    coeffs = td.pressure_gradient_coeffs(Tk, rho_d, q_v)
    Ps, Pxi, Pqv = coeffs
    dpdr = Ps * dr[0] + Pxi * dr[1] + Pqv * (dr[2] / mu_fac)
    dpdl = Ps * dl[0] + Pxi * dl[1] + Pqv * (dl[2] / mu_fac)
    dpdz = ctx.vertical_pgf(coeffs, dz[0], dz[1], dz[2] / mu_fac)

    # microphysics (rainfall_test rates, testModels.jl:387-585)
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
    div3 = u / r + dr[3] + dl[4] / r + dz[5]
    s_div = Cm * (td.Rd + q_v * td.Rv) * div3
    qss_cond = (
        mp.dqsdp(Tk, p, rho_d, q_v, q_l)
        * (u * dpdr + (v / r) * dpdl + w * (dpdz - rhobar * td.GRAVITY))
        - qss * (cloudtau + raintau)
    )

    nvars = ctx.grid.nvars
    sh, dt = u.shape, u.dtype
    extra, imp = {}, {}
    extra[0] = s_cond + s_div
    extra[1] = -div3
    imp[1] = -dz[5]
    extra[2] = mu_fac * (q_evap - q_cond)
    imp[2] = q_v
    extra[3] = (f_cor + v / r) * v - dpdr / rho_t - K * u / (r * r)
    extra[4] = -(f_cor + v / r) * u - dpdl / (r * rho_t) - K * v / (r * r)
    extra[5] = ((-td.GRAVITY * rho_p) - dpdz) / rho_t
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
            torch.broadcast_to(torch.as_tensor(k_v, dtype=dt, device=u.device), sh)
            if ivd else None
        ),
    )


@equation_set(geometry="XYZ")
def MoistEulerXYZ(fields, ctx: EqContext) -> EqResult:
    """3-D Cartesian-box moist compressible Euler core with warm rain, term
    for term as ``scythe_tpu.equations.test_models.MoistEulerXYZ``: the
    perturbation thermodynamics and Ooyama microphysics of rainfall_test in a
    periodic-y box with an optional f-plane, its terms in rainfall_test's
    order with the y/v terms inserted, so that a y-invariant state with
    v = 0 and f = 0 reduces to the RZ set.

    Vars: s xi mu u v w mu_c mu_r qss  (u = dx-wind, v = dy-wind).  The
    dl/dll slots of an XYZ grid are true d/dy, d2/dy2.
    """
    K = ctx.p("K")
    f_cor = ctx.p("f", 0.0)
    rs = ctx.ref_state
    val, dx, dxx, dy, dyy, dz, dzz = (
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
    q_t = q_v + q_l
    rho_t = rho_d * (1.0 + q_t)
    mu_fac = td.dmudq(mu_total, q_v)
    qvp_x = dx[2] / mu_fac
    qvp_y = dy[2] / mu_fac
    qvp_z = dz[2] / mu_fac
    rhobar = td.dry_density(rs.xibar[None, None, :, 0]) * (
        1.0
        + td.ahyp(rs.mubar[None, None, :, 0])
        + td.ahyp(rs.mu_lbar[None, None, :, 0])
    )
    rho_p = rho_t - rhobar
    # shared local PGF coefficients; the vertical carries the exact
    # reference-gradient cross term (EqContext.vertical_pgf)
    coeffs = td.pressure_gradient_coeffs(Tk, rho_d, q_v)
    Ps, Pxi, Pqv = coeffs
    dpdx = Ps * dx[0] + Pxi * dx[1] + Pqv * qvp_x
    dpdy = Ps * dy[0] + Pxi * dy[1] + Pqv * qvp_y
    dpdz = ctx.vertical_pgf(coeffs, dz[0], dz[1], qvp_z)

    Cm = (q_l * td.Cl) / (td.Cvd + q_v * td.Cvv + q_l * td.Cl)
    s_div = Cm * (td.Rd + q_v * td.Rv) * (dx[3] + dy[4] + dz[5])
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
    qss_cond = (
        mp.dqsdp(Tk, p, rho_d, q_v, q_l)
        * ((u * dpdx) + (v * dpdy) + (w * (dpdz - rhobar * td.GRAVITY)))
        - qss * (cloudtau + raintau)
    )
    q_auto = mp.autoconversion(q_c, rho_d)
    q_coll = mp.collection(q_c, q_r, rho_d, Tk)
    Vt = ctx.sedimentation(q_r, rho_d, Tk)
    Vt_flux = ctx.grid.column_flux_derivative(q_r * Vt) / rho_d

    def adv(i, bar_z=None):
        # rainfall_test's (-u dx) + (-w (dz + bar)) with the y term after x
        wdz = dz[i] if bar_z is None else (dz[i] + bar_z)
        return (-u * dx[i]) + (-v * dy[i]) + (-w * wdz)

    # physical_params['K_v']: separate constant vertical diffusivity
    K_v_const = ctx.p("K_v", K)  # a traced parameter stays a tensor
    cs = float(ctx.options.get("smagorinsky", 0.0) or 0.0)
    ivd = bool(ctx.options.get("implicit_vdiff"))
    smag_h = str(ctx.options.get("smagorinsky_axes", "rlz")) == "rl"
    K_eff, Kz_eff, k_v = K, K_v_const, (K_v_const if ivd else None)
    if cs > 0.0:
        k_t = tb.smagorinsky_viscosity(
            ctx.grid, ctx.ts, cs,
            (dx[3], dy[3], dz[3]), (dx[4], dy[4], dz[4]),
            (dx[5], dy[5], dz[5]), u.dtype,
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

    def lap(i):
        # rainfall_test's K (dxx + dzz) with dyy inserted in the middle
        if ivd:
            return K_eff * (dxx[i] + dyy[i])
        if same_param(K_v_const, K) and not smag_h:
            return K_eff * (dxx[i] + dyy[i] + dzz[i])
        return K_eff * (dxx[i] + dyy[i]) + Kz_eff * dzz[i]

    nvars = ctx.grid.nvars
    sh, dt = u.shape, u.dtype
    exp, imp = {}, {}
    exp[0] = adv(0, sbar_z) + s_cond + s_div + lap(0)
    exp[1] = adv(1, xibar_z) - dx[3] - dy[4] - dz[5]
    imp[1] = -dz[5]
    exp[2] = adv(2, mubar_z) + mu_fac * (q_evap - q_cond) + lap(2)
    imp[2] = q_v
    exp[3] = adv(3) + f_cor * v - dpdx / rho_t + lap(3)
    exp[4] = adv(4) - f_cor * u - dpdy / rho_t + lap(4)
    exp[5] = adv(5) + ((-td.GRAVITY * rho_p) - dpdz) / rho_t + lap(5)
    imp[5] = -(ctx.pxi_si() * dz[1])
    exp[6] = adv(6) + ctx.dmudq_source(mu_c, q_c) * (q_cond - q_auto - q_coll) + lap(6)
    exp[7] = adv(7) + ctx.dmudq_source(mu_r, q_r) * (
        q_auto + q_coll - q_evap - Vt_flux
    ) + lap(7)
    exp[8] = adv(8) + qss_cond
    imp[8] = qss
    return EqResult(
        expdot=stack_tendencies(nvars, sh, dt, exp),
        impdot=stack_tendencies(nvars, sh, dt, imp),
        k_v=(
            torch.broadcast_to(torch.as_tensor(k_v, dtype=dt, device=u.device), sh)
            if ivd else None
        ),
    )
