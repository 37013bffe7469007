"""``options["sponge_width"]`` (with ``sponge_tau``, 600 s by default): the
radial sponge, relaxing the outer ``sponge_width`` metres toward the
filtered initial state at the rate sin^2 / tau, after the surface fluxes.
"""

from __future__ import annotations

import numpy as np
import torch

STAGE = "tendency"
ORDER = 20
PARAMS = ("sponge_tau",)


def on_initialize(ctx, grid, spec0):
    """The sponge's reference: the initial state as the grid filters it."""
    ctx.extras["sponge_ref"] = grid.synthesis(spec0)["val"].clone()


def build(model, grid, ctx, dtype):
    opts = ctx.options
    p = grid.params
    width = float(opts["sponge_width"])
    tau = float(opts.get("sponge_tau", 600.0))
    ramp = torch.clamp((ctx.coords["r"] - (p.xmax - width)) / width, 0.0, 1.0)
    sigma = (torch.sin(0.5 * np.pi * ramp) ** 2 / tau).to(dtype)[None]

    def tendency(expdot, phys, fields):
        return expdot - sigma * (phys - ctx.extras["sponge_ref"])

    return tendency
