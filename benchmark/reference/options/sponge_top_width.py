"""``options["sponge_top_width"]`` (with ``sponge_top_tau``, 600 s by
default, and ``sponge_top_vars``, every variable by default): the top
sponge, relaxing the top ``sponge_top_width`` metres toward the filtered
initial state at the rate sin^2 / tau of the depth into the layer, after
the radial sponge (the port adds both rates into one before it multiplies,
which differs in the last bit).
"""

from __future__ import annotations

import numpy as np
import torch

from .sponge_width import on_initialize  # noqa: F401  (the same reference state)

STAGE = "tendency"
ORDER = 21
PARAMS = ("sponge_top_tau", "sponge_top_vars")


def build(model, grid, ctx, dtype):
    opts = ctx.options
    p = grid.params
    if "z" not in ctx.coords:
        raise ValueError(f"sponge_top_width needs a vertical axis ({p.geometry} has none)")
    width = float(opts["sponge_top_width"])
    tau = float(opts.get("sponge_top_tau", 600.0))
    ramp = torch.clamp((ctx.coords["z"] - (p.zmax - width)) / width, 0.0, 1.0)
    sigma = (torch.sin(0.5 * np.pi * ramp) ** 2 / tau).to(dtype)[None]
    names = opts.get("sponge_top_vars")
    if names is not None:
        keep = torch.zeros((grid.nvars,) + (1,) * (sigma.ndim - 1), dtype=dtype,
                           device=grid.device)
        for name in names:
            keep[p.var_index(name)] = 1.0
        sigma = sigma * keep

    def tendency(expdot, phys, fields):
        return expdot - sigma * (phys - ctx.extras["sponge_ref"])

    return tendency
