"""Shallow-water equation sets (ref src/shallowWaterModels.jl), in PyTorch.

The counterpart of ``scythe_tpu.equations.shallow_water``, term for term:
the linear and nonlinear shallow-water sets, the Cha & Bell (2024)
two-layer shallow-water / slab-boundary-layer tropical cyclone models
(one-way and two-way feedback) and the height-resolved boundary-layer
variant on the RLZ grid.  The tendencies are plain tensor arithmetic; no
set writes into a tensor of ``fields`` (they are views of the synthesis
buffers).
"""

from __future__ import annotations

import torch

from .common import EqContext, EqResult, equation_set, stack_tendencies


@equation_set(geometry="R")
def LinearShallowWater1D(fields, ctx: EqContext) -> EqResult:
    """(ref shallowWaterModels.jl:235-258). Vars: h, u."""
    g, K, H = ctx.p("g"), ctx.p("K"), ctx.p("H")
    h_r = fields["dr"][0]
    u_r, u_rr = fields["dr"][1], fields["drr"][1]
    exp = {0: -H * u_r, 1: (-g * h_r) + K * u_rr}
    return EqResult(
        expdot=stack_tendencies(ctx.grid.nvars, h_r.shape, h_r.dtype, exp)
    )


@equation_set(geometry="RL")
def LinearShallowWaterRL(fields, ctx: EqContext) -> EqResult:
    """(ref shallowWaterModels.jl:260-298). Vars: h, u, v."""
    g, K, H = ctx.p("g"), ctx.p("K"), ctx.p("H")
    r = ctx.coords["r"]
    val, dr, drr, dl, dll = (
        fields["val"],
        fields["dr"],
        fields["drr"],
        fields["dl"],
        fields["dll"],
    )
    h, hr, hl = val[0], dr[0], dl[0]
    u, ur, urr, ull = val[1], dr[1], drr[1], dll[1]
    v, vr, vrr, vll = val[2], dr[2], drr[2], dll[2]
    vl = dl[2]
    exp = {
        0: -H * ((u / r) + ur + (vl / r)),
        1: (-g * hr) + K * ((ur / r) + urr + (ull / (r * r))),
        2: (-g * (hl / r)) + K * ((vr / r) + vrr + (vll / (r * r))),
    }
    return EqResult(expdot=stack_tendencies(ctx.grid.nvars, h.shape, h.dtype, exp))


@equation_set(geometry="RL")
def ShallowWaterRL(fields, ctx: EqContext) -> EqResult:
    """Nonlinear shallow water (ref shallowWaterModels.jl:300-344).

    Note: the reference version of this set forgets to call the explicit
    stepper (a latent reference bug, SURVEY.md 7.2); here the stepper runs
    for every equation set, so this set actually integrates.
    """
    g, K, H, f = ctx.p("g"), ctx.p("K"), ctx.p("H"), ctx.p("f")
    r = ctx.coords["r"]
    val, dr, drr, dl, dll = (
        fields["val"],
        fields["dr"],
        fields["drr"],
        fields["dl"],
        fields["dll"],
    )
    h, hr, hl = val[0], dr[0], dl[0]
    u, ur, urr, ul, ull = val[1], dr[1], drr[1], dl[1], dll[1]
    v, vr, vrr, vl, vll = val[2], dr[2], drr[2], dl[2], dll[2]
    exp = {
        0: (-v * hl / r) + (-u * hr) + (-(H + h) * ((u / r) + ur + (vl / r))),
        1: (
            (-v * ul / r)
            + (-u * ur)
            + (-g * hr)
            + v * (f + v / r)
            + K * ((ur / r) + urr + (ull / (r * r)) - (u / (r * r)))
        ),
        2: (
            (-v * vl / r)
            + (-u * vr)
            + (-g * (hl / r))
            + (-u * (f + v / r))
            + K * ((vr / r) + vrr + (vll / (r * r)) - (v / (r * r)))
        ),
    }
    return EqResult(expdot=stack_tendencies(ctx.grid.nvars, h.shape, h.dtype, exp))


def _slab_core(fields, ctx: EqContext, twoway: bool) -> EqResult:
    """Cha & Bell (2024) shallow-water + slab BL
    (ref shallowWaterModels.jl:1-233).  Vars: h ug vg ub vb wb."""
    g = ctx.p("g")
    K = ctx.p("K")
    Cd = ctx.p("Cd")
    Hfree = ctx.p("Hfree")
    Hb = ctx.p("Hb")
    f = ctx.p("f")
    r = ctx.coords["r"]
    val, dr, drr, dl, dll = (
        fields["val"],
        fields["dr"],
        fields["drr"],
        fields["dl"],
        fields["dll"],
    )
    h, hr, hl = val[0], dr[0], dl[0]
    ug, ugr, ugl = val[1], dr[1], dl[1]
    vg, vgr, vgl = val[2], dr[2], dl[2]
    ub, ubr, ubrr, ubl, ubll = val[3], dr[3], drr[3], dl[3], dll[3]
    vb, vbr, vbrr, vbl, vbll = val[4], dr[4], drr[4], dl[4], dll[4]

    # parameterized surface wind (ref :59-63)
    U = 0.78 * torch.sqrt(ub * ub + vb * vb)

    # diagnostic BL vertical velocity (ref :65-68)
    w = -Hb * ((ub / r) + ubr + (vbl / r))
    w_ = 0.5 * torch.abs(w) - w

    exp = {}
    # h tendency (ref :70-73 / two-way :186-194)
    hadv = (-vg * hl / r) + (-ug * hr)
    hdiv = -(Hfree + h) * ((ug / r) + ugr + (vgl / r))
    if twoway:
        S1 = ctx.p("S1")
        exp[0] = hadv + hdiv - (Hfree + h) * w * S1
    else:
        exp[0] = hadv + hdiv

    # ug tendency (ref :75-79)
    exp[1] = (-vg * ugl / r) + (-ug * ugr) + (-g * hr) + vg * (f + vg / r)
    # vg tendency (ref :81-85)
    exp[2] = (-vg * vgl / r) + (-ug * vgr) + (-g * (hl / r)) - ug * (f + vg / r)

    # ub tendency (ref :87-98)
    exp[3] = (
        (-vb * ubl / r)
        + (-ub * ubr)
        + (-g * hr)
        + vb * (f + vb / r)
        - (Cd * U * ub / Hb)
        + w_ * (ug - ub) / Hb
        + K
        * ((ubr / r) + ubrr - (ub / (r * r)) + (ubll / (r * r)) - (2.0 * vbl / (r * r)))
    )
    # vb tendency (ref :100-110)
    exp[4] = (
        (-vb * vbl / r)
        + (-ub * vbr)
        + (-g * (hl / r))
        - ub * (f + vb / r)
        - (Cd * U * vb / Hb)
        + w_ * (vg - vb) / Hb
        + K
        * ((vbr / r) + vbrr - (vb / (r * r)) + (vbll / (r * r)) + (2.0 * ubl / (r * r)))
    )
    # wb is diagnostic: tendency 0, physical value overwritten (ref :65-68)
    return EqResult(
        expdot=stack_tendencies(ctx.grid.nvars, h.shape, h.dtype, exp),
        overrides={5: w},
    )


@equation_set(geometry="RL")
def Oneway_ShallowWater_Slab(fields, ctx: EqContext) -> EqResult:
    return _slab_core(fields, ctx, twoway=False)


@equation_set(geometry="RL")
def Twoway_ShallowWater_Slab(fields, ctx: EqContext) -> EqResult:
    return _slab_core(fields, ctx, twoway=True)


@equation_set(geometry="RLZ")
def Oneway_ShallowWater_HeightResolvedBL(fields, ctx: EqContext) -> EqResult:
    """Height-resolved boundary layer under a fixed shallow-water layer
    (ref shallowWaterModels.jl:346-511).  Vars: h ug vg ub vb wb.

    Fields are [nvars, rDim, nl, nz]; the free-layer variables (h, ug, vg)
    are z-uniform copies of the 2-D layer.
    """
    g = ctx.p("g")
    Kh = ctx.p("Kh")
    Cd0 = ctx.p("Cd")
    Hfree = ctx.p("Hfree")
    f = ctx.p("f")
    Um = ctx.p("Um")
    Vm = ctx.p("Vm")
    r = ctx.coords["r"]
    lam = ctx.coords["l"]
    z = ctx.coords["z"]
    val, dr, drr, dl, dll = (
        fields["val"],
        fields["dr"],
        fields["drr"],
        fields["dl"],
        fields["dll"],
    )
    dz, dzz = fields["dz"], fields["dzz"]
    h, hr, hl = val[0], dr[0], dl[0]
    ug, ugr, ugl = val[1], dr[1], dl[1]
    vg, vgr, vgl = val[2], dr[2], dl[2]
    ub, ubr, ubrr, ubl, ubll, ubz = val[3], dr[3], drr[3], dl[3], dll[3], dz[3]
    vb, vbr, vbrr, vbl, vbll, vbz = val[4], dr[4], drr[4], dl[4], dll[4], dz[4]

    # Louis-type mixing length vertical diffusivity (ref :411-416)
    S = torch.sqrt(ubz * ubz + vbz * vbz)
    l_mix = 1.0 / ((1.0 / (0.4 * z)) + (1.0 / 80.0))
    Kv = (l_mix**2) * S

    # wb diagnostic: vertical integral of BL divergence (ref :418-429)
    div = -((ub / r) + ubr + (vbl / r))
    wb = ctx.grid.column_integrate(div)

    exp = {}
    exp[0] = (-vg * hl / r) + (-ug * hr) - (Hfree + h) * ((ug / r) + ugr + (vgl / r))
    exp[1] = (-vg * ugl / r) + (-ug * ugr) + (-g * hr) + vg * (f + vg / r)
    exp[2] = (-vg * vgl / r) + (-ug * vgr) + (-g * (hl / r)) - ug * (f + vg / r)

    # storm-motion surface wind and wind-speed dependent drag (ref :455-480)
    sfcu = Um * torch.cos(lam) + Vm * torch.sin(lam)
    sfcv = Vm * torch.cos(lam) - Um * torch.sin(lam)
    u10 = ub[:, :, 1:2] + sfcu  # 10 m wind at second mish level (ref :459-463)
    v10 = vb[:, :, 1:2] + sfcv
    U10 = torch.sqrt(u10**2 + v10**2)
    Cd = torch.where(
        U10 < 5.2,
        torch.full_like(U10, 1.0e-3),
        torch.where(U10 < 33.6, 4.4e-4 * torch.sqrt(U10), torch.full_like(U10, Cd0)),
    )

    # vertical diffusion: d/dz of (Kv du/dz) with the surface drag encoded
    # in the z=0 (first mish) value (ref :468-483)
    # a fresh tensor: the drag at level 0, Kv du/dz above it
    flux_u = torch.cat([Cd * U10 * u10, (Kv * ubz)[:, :, 1:]], dim=2)
    flux_v = torch.cat([Cd * U10 * v10, (Kv * vbz)[:, :, 1:]], dim=2)
    vdiff_u = ctx.grid.column_derivative(flux_u)
    vdiff_v = ctx.grid.column_derivative(flux_v)

    exp[3] = (
        (-vb * ubl / r)
        + (-ub * ubr)
        + (-wb * ubz)
        + (-g * hr)
        + vb * (f + vb / r)
        + vdiff_u
        + Kh
        * ((ubr / r) + ubrr - (ub / (r * r)) + (ubll / (r * r)) - (2.0 * vbl / (r * r)))
    )
    exp[4] = (
        (-vb * vbl / r)
        + (-ub * vbr)
        + (-wb * vbz)
        + (-g * (hl / r))
        - ub * (f + vb / r)
        + vdiff_v
        + Kh
        * ((vbr / r) + vbrr - (vb / (r * r)) + (vbll / (r * r)) + (2.0 * ubl / (r * r)))
    )
    return EqResult(
        expdot=stack_tendencies(ctx.grid.nvars, h.shape, h.dtype, exp),
        overrides={5: wb},
    )
