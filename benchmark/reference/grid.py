"""The reference's grids, found by geometry: ``create_grid`` builds the grid
of ``benchmark/reference/grids/<geometry>.py`` (its ``create``).  Each such
module holds one geometry of ``scythe_tpu_torch/grids/`` in plain mode with
the dense DFT, frozen for the benchmark's reference, and the dense FLOPs of
its transforms (``synthesis_flops``, ``analysis_flops``) that the step's
FLOP count (``yardsticks.step_flops``) reads.  A geometry with no module is
refused.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np
import torch

from .config import GridParameters


@dataclass
class Grid:
    """What every geometry's grid has."""

    params: GridParameters
    dtype: torch.dtype
    device: torch.device

    @property
    def geometry(self) -> str:
        return self.params.geometry

    @property
    def _struct(self) -> str:
        return self.params.geometry

    @property
    def nvars(self) -> int:
        return self.params.nvars

    @property
    def num_points(self) -> int:
        return int(np.prod(self.spatial_shape))


def geometry_module(geometry: str):
    """``benchmark/reference/grids/<geometry>.py``."""
    name = f"{__package__}.grids.{geometry}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"the reference has no {geometry!r} grid: add "
                         f"benchmark/reference/grids/{geometry}.py") from None


def create_grid(p: GridParameters, dtype: torch.dtype, device) -> Grid:
    """The grid's operators, as the port's ``create_grid`` builds them in
    plain mode with the dense DFT."""
    return geometry_module(p.geometry).create(p, dtype, torch.device(device))
