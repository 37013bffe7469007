"""The reference's grids, found by geometry: ``create_grid`` builds the grid
of ``benchmark/reference/grids/<geometry>.py`` (its ``create``).  Each such
module holds one geometry of ``scythe_tpu_torch/grids/`` in plain mode with
the dense DFT, frozen for the benchmark's reference, and the dense FLOPs of
its transforms (``synthesis_flops``, ``analysis_flops``) that the step's
FLOP count (``yardsticks.step_flops``) reads.  A geometry with no module is
refused.  As in the port, XYZ and SLZ share the RLZ array ranks
(``_struct``), SL the RL ones: the option modules that work on coefficients
(``options/modal_filter_tau.py``) go by it.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np
import torch

from . import fourier
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
        """Structural class: XYZ and SLZ share the RLZ array ranks, SL the RL
        ones."""
        g = self.params.geometry
        return {"XYZ": "RLZ", "SL": "RL", "SLZ": "RLZ"}.get(g, g)

    @property
    def nvars(self) -> int:
        return self.params.nvars

    @property
    def num_points(self) -> int:
        return int(np.prod(self.spatial_shape))

    def slot_wavenumbers(self) -> np.ndarray:
        """|k| of each azimuthal coefficient slot of the dense DFT."""
        return np.abs(fourier.coeff_wavenumbers(self.nl)).astype(np.float64)


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
