"""The Cha & Bell (2024) two-layer core (``scythe_tpu_torch/equations/
shallow_water.py``), frozen for the benchmark's reference term for term:
the one-way and two-way slab sets of ``eqsets/`` are this core.
"""

from __future__ import annotations

import torch

from .equations import EqContext, EqResult, stack_tendencies


def slab_core(fields, ctx: EqContext, twoway: bool) -> EqResult:
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
