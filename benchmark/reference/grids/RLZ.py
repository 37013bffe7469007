"""The RLZ grid (radius x azimuth x height) of
``scythe_tpu_torch/grids/base.py`` in plain mode with the dense DFT: the RL
grid's operators and a Chebyshev column; the analysis is the einsum chain
the port's ``rlz_analysis`` kernel replaces.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import chebyshev, fourier
from ..config import GridParameters
from . import RL
from .RL import RLGrid, ring_operators


@dataclass
class RLZGrid(RLGrid):
    z_mish: np.ndarray
    analysis_z: torch.Tensor  # [nvars, nz, nz]
    z_all: torch.Tensor  # [3, nz, nz]
    zcol_deriv_ftop: torch.Tensor

    @property
    def spatial_shape(self) -> tuple[int, ...]:
        return (self.params.rDim, self.nl, self.params.zDim)

    def coords(self) -> dict[str, torch.Tensor]:
        r = torch.as_tensor(self.r_mish, dtype=self.dtype, device=self.device)
        lam = torch.as_tensor(fourier.angles(self.nl), dtype=self.dtype, device=self.device)
        z = torch.as_tensor(self.z_mish, dtype=self.dtype, device=self.device)
        return {"r": r[:, None, None], "l": lam[None, :, None], "z": z[None, None, :]}

    def gridpoints(self) -> np.ndarray:
        rr, ll, zz = np.meshgrid(self.r_mish, fourier.angles(self.nl), self.z_mish,
                                 indexing="ij")
        return np.stack([rr.ravel(), ll.ravel(), zz.ravel()], axis=1)

    def analysis(self, phys: torch.Tensor) -> torch.Tensor:
        """physical [nvars, *spatial] -> spectral: the lambda DFT and its ring
        mask, the radial contraction, then the vertical analysis."""
        hat = torch.einsum("kl,vrlz->vrkz", self.l_analysis, phys)
        hat = hat * self.ring_mask[None, :, :, None]
        rc = torch.einsum("vbr,vrkz->vbkz", self.analysis_r, hat)
        return torch.einsum("vKz,vbkz->vbkK", self.analysis_z, rc)

    def synthesis(self, spec: torch.Tensor) -> dict[str, torch.Tensor]:
        zc = torch.einsum("dzK,vbkK->vdbkz", self.z_all, spec)
        lv = torch.einsum("dlk,vbkz->vdblz", self.l_all, zc[:, 0])
        lz = torch.einsum("lk,vdbkz->vdblz", self.l_synth, zc[:, 1:])
        r3 = torch.einsum("drb,vblz->vdrlz", self.synth_r, lv[:, 0])
        rl = torch.einsum("rb,vdblz->vdrlz", self.synth_r_val, lv[:, 1:])
        rz = torch.einsum("rb,vdblz->vdrlz", self.synth_r_val, lz)
        return {"val": r3[:, 0], "dr": r3[:, 1], "drr": r3[:, 2], "dl": rl[:, 0],
                "dll": rl[:, 1], "dz": rz[:, 0], "dzz": rz[:, 1]}

    def column_flux_derivative(self, f: torch.Tensor) -> torch.Tensor:
        """d/dz of a vertical flux with F = 0 imposed at the domain top."""
        return torch.einsum("zk,...k->...z", self.zcol_deriv_ftop, f)


def create(p: GridParameters, dtype, device) -> RLZGrid:
    def tensor(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    anz = []
    for v in range(p.nvars):
        zops = chebyshev.build_ops(p.zDim, p.zmin, p.zmax, p.b_zDim, p.BCB[v], p.BCT[v])
        anz.append(zops.constrain @ zops.analysis)
    z0 = chebyshev.build_ops(p.zDim, p.zmin, p.zmax, p.b_zDim)
    zf = chebyshev.build_ops(p.zDim, p.zmin, p.zmax, p.b_zDim,
                             chebyshev.ZBC.R0, chebyshev.ZBC.R1T0)
    return RLZGrid(**ring_operators(p, dtype, device), z_mish=z0.points,
                   analysis_z=tensor(np.stack(anz)),
                   z_all=tensor(np.stack([z0.synth, z0.dsynth, z0.d2synth])),
                   zcol_deriv_ftop=tensor(z0.dsynth @ (zf.constrain @ zf.analysis)))


def shape(p: GridParameters) -> dict:
    """``RL.shape`` with the levels."""
    return {**RL.shape(p), "Z": p.zDim}


def synthesis_flops(V, R, L, B, Z):
    """Dense FLOPs of ``RLZGrid.synthesis``: the three vertical slots, then
    the azimuthal and radial ones."""
    return 2 * V * (3 * B * L * Z * Z + 3 * B * L * L * Z + 2 * B * L * L * Z
                    + 3 * R * B * L * Z + 2 * R * B * L * Z + 2 * R * B * L * Z)


def analysis_flops(V, R, L, B, Z):
    """Dense FLOPs of ``RLZGrid.analysis``: the azimuthal DFT, the radial
    contraction and the vertical analysis."""
    return 2 * V * (R * L * L * Z + B * R * L * Z + B * L * Z * Z)
