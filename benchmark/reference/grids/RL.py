"""The RL grid (radius x azimuth) of ``scythe_tpu_torch/grids/base.py`` in
plain mode with the dense DFT: every transform is an ``einsum`` by a dense
operator built in float64 numpy and cast once.  The compensated mode and
the factored DFT are left out: no cell runs them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import bspline, fourier
from ..config import GridParameters
from ..grid import Grid


@dataclass
class RLGrid(Grid):
    r_mish: np.ndarray
    analysis_r: torch.Tensor  # [nvars, nb, rDim]
    synth_r: torch.Tensor  # [3, rDim, nb]
    synth_r_val: torch.Tensor  # [rDim, nb]
    nl: int
    ring_mask: torch.Tensor  # [rDim, nl]
    l_analysis: torch.Tensor  # [nl, nl]
    l_synth: torch.Tensor  # [nl, nl]
    l_all: torch.Tensor  # [3, nl, nl]

    @property
    def spatial_shape(self) -> tuple[int, ...]:
        return (self.params.rDim, self.nl)

    def coords(self) -> dict[str, torch.Tensor]:
        r = torch.as_tensor(self.r_mish, dtype=self.dtype, device=self.device)
        lam = torch.as_tensor(fourier.angles(self.nl), dtype=self.dtype, device=self.device)
        return {"r": r[:, None], "l": lam[None, :]}

    def gridpoints(self) -> np.ndarray:
        """[npoints, ndims] coordinates in the flattened field order."""
        rr, ll = np.meshgrid(self.r_mish, fourier.angles(self.nl), indexing="ij")
        return np.stack([rr.ravel(), ll.ravel()], axis=1)

    def analysis(self, phys: torch.Tensor) -> torch.Tensor:
        """physical [nvars, *spatial] -> spectral: the lambda DFT and its ring
        mask, then the radial contraction."""
        hat = torch.einsum("kl,vrl->vrk", self.l_analysis, phys) * self.ring_mask[None]
        return torch.einsum("vbr,vrk->vbk", self.analysis_r, hat)

    def synthesis(self, spec: torch.Tensor) -> dict[str, torch.Tensor]:
        """spectral -> every derivative slot, ``[nvars, *spatial]`` each."""
        lc = torch.einsum("dlk,vbk->vdbl", self.l_all, spec)
        r3 = torch.einsum("drb,vbl->vdrl", self.synth_r, lc[:, 0])
        rd = torch.einsum("rb,vdbl->vdrl", self.synth_r_val, lc[:, 1:])
        return {"val": r3[:, 0], "dr": r3[:, 1], "drr": r3[:, 2], "dl": rd[:, 0],
                "dll": rd[:, 1]}


def ring_operators(p: GridParameters, dtype, device) -> dict:
    """The radial B-spline and azimuthal DFT operators of ``RLGrid``."""

    def tensor(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    an = []
    for v in range(p.nvars):
        ops = bspline.build_ops(p.xmin, p.xmax, p.num_cells, p.BCL[v], p.BCR[v], p.l_q)
        an.append(ops.analysis)
    nl = fourier.default_nl(p.num_cells, p.lDim)
    la, ls, ld, ld2 = fourier.dft_matrices(nl)
    dr = (p.xmax - p.xmin) / p.num_cells
    return dict(
        params=p, dtype=dtype, device=device, r_mish=ops.mish,
        analysis_r=tensor(np.stack(an)), synth_r=tensor(ops.synth),
        synth_r_val=tensor(ops.synth[0]), nl=nl,
        ring_mask=tensor(fourier.ring_coeff_mask(ops.mish, dr, nl, p.l_q)),
        l_analysis=tensor(la), l_synth=tensor(ls), l_all=tensor(np.stack([ls, ld, ld2])),
    )


def create(p: GridParameters, dtype, device) -> RLGrid:
    return RLGrid(**ring_operators(p, dtype, device))


def shape(p: GridParameters) -> dict:
    """The sizes the yardsticks count by: variables, radial points and
    coefficients, azimuthal points, levels (none)."""
    return {"V": p.nvars, "R": p.rDim, "L": fourier.default_nl(p.num_cells, p.lDim),
            "B": p.b_rDim, "Z": 0}


def synthesis_flops(V, R, L, B, Z=0):
    """Dense FLOPs of ``RLGrid.synthesis``: the three azimuthal slots on the
    coefficients, then the radial value and its two derivatives and the
    radial value of the two azimuthal slots."""
    return 2 * V * (3 * B * L * L + 3 * R * B * L + 2 * R * B * L)


def analysis_flops(V, R, L, B, Z=0):
    """Dense FLOPs of ``RLGrid.analysis``: the azimuthal DFT and the radial
    contraction."""
    return 2 * V * (R * L * L + B * R * L)
