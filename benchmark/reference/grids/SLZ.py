"""The SLZ spherical shell (latitude x longitude x height) of
``scythe_tpu_torch/grids/base.py`` in plain mode with the dense DFT: the
RLZ grid's operators with latitude in radians in place of the radius, the
longitude DFT at the explicit ``lDim`` and each ring's zonal modes kept by
its circumference, a cos(lat), as r's on the polar grids.

The derivative slots stay coordinate derivatives (``dr`` d/dphi, ``dl``
d/dlambda): an equation set divides by a and a cos(phi) where it uses them.
``coords`` gives ``lat``, ``lon`` and ``z``, with ``r`` and ``l`` the same
tensors, so the options that read the outer boundary work unchanged.

Departures from the port: the compensated mode and the factored DFT are
left out (no cell runs them); the FLOP counts are the RLZ formulas (the
same structural class), for one synthesis and one analysis a step, so a
step's count leaves out an equation set's own refit (``MoistEulerSLZ``'s
del^4 runs a second pair).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import fourier
from ..config import GridParameters
from . import RLZ
from .RLZ import RLZGrid


@dataclass
class SLZGrid(RLZGrid):
    def coords(self) -> dict[str, torch.Tensor]:
        out = super().coords()
        out["lat"], out["lon"] = out["r"], out["l"]
        return out


def create(p: GridParameters, dtype, device) -> SLZGrid:
    if not p.lDim or p.lDim % 2:
        raise ValueError("SLZ grids need an explicit even lDim (longitude points)")
    if not (p.xmax > p.xmin and abs(p.xmin) <= np.pi / 2 + 1e-9
            and abs(p.xmax) <= np.pi / 2 + 1e-9):
        raise ValueError(f"SLZ latitude bounds must be radians within [-pi/2, pi/2], "
                         f"got [{p.xmin}, {p.xmax}]")
    grid = RLZ.create(p, dtype, device)
    dphi = (p.xmax - p.xmin) / p.num_cells
    a = p.sphere_radius
    mask = fourier.ring_coeff_mask(a * np.cos(grid.r_mish), a * dphi, grid.nl, p.l_q)
    fields = {k: getattr(grid, k) for k in grid.__dataclass_fields__}
    fields["ring_mask"] = torch.as_tensor(mask, dtype=dtype, device=device)
    return SLZGrid(**fields)


shape = RLZ.shape  # the longitudes are lDim
synthesis_flops = RLZ.synthesis_flops
analysis_flops = RLZ.analysis_flops
