"""``MoistEulerRLZ`` (``scythe_tpu_torch/equations/test_models.py``), frozen
for the benchmark's reference term for term, with the condensation
adjustment the port's step applies after its update.
"""

from __future__ import annotations

import torch

from .. import microphysics as mp
from .. import thermodynamics as td
from .. import turbulence as tb
from ..equations import EqContext, EqResult, field_of, laplacian_mask, same_param, stack_tendencies

# the options this set's tendency and adjustment read
OPTIONS = frozenset({"sedimentation", "stiff_relaxation", "condensation", "condensation_tau",
                     "condensation_rate_cap", "smagorinsky"})


def tendency(fields, ctx: EqContext) -> EqResult:
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
    lap_mask = laplacian_mask(dr.dtype, dr.device)
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
            field_of(k_v, sh, dt, u.device)
            if ivd else None
        ),
    )


def after_update(var_np1, impdot, ctx: EqContext):
    return mp.condensation_adjustment(var_np1, impdot, ctx)
