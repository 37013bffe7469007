"""Tropical-cyclone boundary-layer equation sets (ref src/tcblModels.jl), in
PyTorch: the counterpart of ``scythe_tpu.equations.tcbl``, term for term.

The reference versions are experimental and broken as shipped (undefined
``F``/``UPGF``/``udot`` references, missing ``t`` argument in the dispatch
signature, and Kepert2017 is flagged "This code won't work now!",
tcblModels.jl:25,98,110,130).  These are repaired implementations of the
same physics; each repair is noted inline.
"""

from __future__ import annotations

import torch

from .common import EqContext, EqResult, equation_set, stack_tendencies


def _slab_tcbl(fields, ctx: EqContext, r) -> EqResult:
    """Williams (2013) slab TCBL core.  Vars: vgr u v w.

    Repairs vs the reference: ``F[:,1]`` (undefined, tcblModels.jl:25)
    dropped; ``UPGF`` (undefined in RL variant, :98) restored to the
    gradient-wind imbalance used by the R variant; the ``UKDIFF`` typo in
    the vb tendency (:56) corrected to ``VKDIFF``.
    """
    K = ctx.p("K")
    Cd = ctx.p("Cd")
    hb = ctx.p("h")
    f = ctx.p("f")
    val, dr, drr = fields["val"], fields["dr"], fields["drr"]
    vgr = val[0]
    u, ur, urr = val[1], dr[1], drr[1]
    v, vr, vrr = val[2], dr[2], drr[2]

    U = 0.78 * torch.sqrt(u * u + v * v)
    w = -hb * ((u / r) + ur)
    w_ = 0.5 * torch.abs(w) - w

    exp = {}
    exp[1] = (
        -(u * ur)
        - (Cd * U * u / hb)
        + (f * v + (v * v) / r)
        - (f * vgr + (vgr * vgr) / r)
        - w_ * (u / hb)
        + K * ((ur / r) + urr - (u / (r * r)))
    )
    exp[2] = (
        -u * (f + (v / r) + vr)
        - (Cd * U * v / hb)
        + w_ * (vgr - v) / hb
        + K * ((vr / r) + vrr - (v / (r * r)))
    )
    return EqResult(
        expdot=stack_tendencies(ctx.grid.nvars, u.shape, u.dtype, exp),
        overrides={3: w},
    )


@equation_set(geometry="R")
def Williams2013_slabTCBL(fields, ctx: EqContext) -> EqResult:
    return _slab_tcbl(fields, ctx, ctx.coords["r"])


@equation_set(geometry="RL")
def RL_SlabTCBL(fields, ctx: EqContext) -> EqResult:
    return _slab_tcbl(fields, ctx, ctx.coords["r"])


@equation_set(geometry="RZ")
def Kepert2017_TCBL(fields, ctx: EqContext) -> EqResult:
    """Kepert (2017) height-resolved TCBL (ref tcblModels.jl:108-205).

    The reference version is explicitly non-functional; this implementation
    follows its stated intent: Louis mixing-length vertical diffusivity,
    surface drag at the lowest level, w from the vertical integral of
    horizontal divergence, and gradient-wind forcing.  Vars: vgr u v w.
    """
    K = ctx.p("K")
    Cd = ctx.p("Cd")
    f = ctx.p("f")
    r = ctx.coords["r"]
    z = ctx.coords["z"]
    val, dr, drr, dz = fields["val"], fields["dr"], fields["drr"], fields["dz"]
    vgr = val[0]
    u, ur, urr, uz = val[1], dr[1], drr[1], dz[1]
    v, vr, vrr, vz = val[2], dr[2], drr[2], dz[2]

    # 10 m wind at the second mish level (ref tcblModels.jl:137-142)
    u10 = u[:, 1:2]
    v10 = v[:, 1:2]
    U10 = torch.sqrt(u10 * u10 + v10 * v10)

    S = torch.sqrt(uz * uz + vz * vz)
    l_mix = 1.0 / ((1.0 / (0.4 * z)) + (1.0 / 80.0))
    Kv = (l_mix**2) * S

    # a fresh tensor: the drag at level 0, Kv du/dz above it
    flux_u = torch.cat([Cd * U10 * u10, (Kv * uz)[:, 1:]], dim=1)
    flux_v = torch.cat([Cd * U10 * v10, (Kv * vz)[:, 1:]], dim=1)
    uvdiff = ctx.grid.column_derivative(flux_u)
    vvdiff = ctx.grid.column_derivative(flux_v)

    div = -((u / r) + ur)
    w = ctx.grid.column_integrate(div)

    exp = {}
    exp[1] = (
        -(u * ur)
        + (f * v + (v * v) / r)
        - (f * vgr + (vgr * vgr) / r)
        - w * uz
        + K * ((ur / r) + urr - (u / (r * r)))
        + uvdiff
    )
    exp[2] = (
        -u * (f + (v / r) + vr)
        - w * vz
        + K * ((vr / r) + vrr - (v / (r * r)))
        + vvdiff
    )
    return EqResult(
        expdot=stack_tendencies(ctx.grid.nvars, u.shape, u.dtype, exp),
        overrides={3: w},
    )
