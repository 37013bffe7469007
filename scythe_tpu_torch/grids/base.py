"""Grid objects: mixed-basis spectral transforms on the reference's four
geometries (R / RL / RZ / RLZ) and the JAX package's XYZ Cartesian box and
SL / SLZ spherical shells, in PyTorch.

The counterpart of ``scythe_tpu.grids.base`` in its plain-matmul mode:

* Physical state is a dense tensor ``[nvars, rDim(, nl)(, nz)]``; vertical
  columns and azimuthal rings are batch axes, and z is always the last
  axis.
* Analysis / synthesis are precomputed dense operators (built in float64
  numpy by ``basis/``, cast once to the grid's dtype and device) applied
  with ``torch.einsum``: cubic B-splines in r, real-DFT matrices with a
  per-ring wavenumber mask in lambda, Chebyshev (dense DCT matrices) in z.
  These are plain GEMMs; the JAX package also leaves them to the compiler.
  The analysis of the RLZ structural class (RLZ, XYZ, SLZ) is the
  exception: on the card it is one hand-written CUDA kernel
  (``ops/rlz_analysis.py``).
* XYZ and SLZ share the RLZ array ranks and transform composition, SL the
  RL ones (``_struct``); only coordinates and the periodic axis' mask and
  scaling differ.  An XYZ grid's dl/dll slots are true d/dy, d2/dy2 (the
  derivative operators scaled by 2 pi / Ly); an SL/SLZ grid's x is latitude
  in radians and its ring mask uses the ring radius a cos(lat).
* ``synthesis`` returns every derivative slot of the reference physical
  layout: value, d/dr, d2/dr2 (+ d/dl, d2/dl2) (+ d/dz, d2/dz2).
* ``project`` + ``solve_spectral`` factor the analysis into a local
  quadrature and a small solve, as in the JAX package.

Every geometry carries its equation sets end to end (R, RL, RZ and SL
through the einsum operators alone).  Not ported yet (each raises
NotImplementedError): the factored DFT (nl > 2048 on any periodic axis) and
``matmul="compensated"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..basis import bspline, chebyshev, fourier
from ..config import GridParameters
from ..device import DEFAULT, resolve_device
from ..ops import rlz_analysis

GEOMETRIES = ("R", "RL", "RZ", "RLZ", "XYZ", "SL", "SLZ")
# the JAX package switches to its factored DFT above this many points
_DENSE_NL_MAX = 2048


@dataclass
class Grid:
    """A built grid: static metadata + operator tensors on one device."""

    params: GridParameters
    dtype: torch.dtype
    device: torch.device
    # radial operators
    r_mish: np.ndarray  # [rDim] (host, float64)
    analysis_r: torch.Tensor  # [nvars, nb, rDim]
    project_r: torch.Tensor  # [nb, rDim]
    msolve_r: torch.Tensor  # [nvars, nb, nb]
    synth_r: torch.Tensor  # [3, rDim, nb]
    synth_r_val: torch.Tensor  # [rDim, nb]
    # azimuthal (real DFT; the spectral state holds lambda coefficients)
    nl: int = 0
    kDim: int = 0
    ring_mask: torch.Tensor | None = None  # [rDim, nl]
    l_analysis: torch.Tensor | None = None  # [nl, nl] values -> coeffs
    l_synth: torch.Tensor | None = None  # [nl, nl] coeffs -> values
    l_all: torch.Tensor | None = None  # [3, nl, nl] coeffs -> (val, dl, dll)
    # vertical
    z_mish: np.ndarray | None = None  # [nz]
    analysis_z: torch.Tensor | None = None  # [nvars, nz, nz]
    z_all: torch.Tensor | None = None  # [3, nz, nz] coeff -> (val, dz, dzz)
    zcol_int: torch.Tensor | None = None
    zcol_deriv: torch.Tensor | None = None
    zcol_filter: torch.Tensor | None = None
    zcol_deriv_ftop: torch.Tensor | None = None

    def _mm(self, subs: str, op: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum(subs, op, x)

    @property
    def geometry(self) -> str:
        return self.params.geometry

    @property
    def nvars(self) -> int:
        return self.params.nvars

    @property
    def _struct(self) -> str:
        """Structural class: XYZ and SLZ share the RLZ array ranks and paths,
        SL the RL ones."""
        g = self.params.geometry
        return {"XYZ": "RLZ", "SL": "RL", "SLZ": "RLZ"}.get(g, g)

    @property
    def spatial_shape(self) -> tuple[int, ...]:
        p = self.params
        if self._struct == "R":
            return (p.rDim,)
        if self._struct == "RL":
            return (p.rDim, self.nl)
        if self._struct == "RZ":
            return (p.rDim, p.zDim)
        return (p.rDim, self.nl, p.zDim)

    @property
    def spectral_shape(self) -> tuple[int, ...]:
        p = self.params
        if self._struct == "R":
            return (p.nvars, p.b_rDim)
        if self._struct == "RL":
            return (p.nvars, p.b_rDim, self.kDim)
        if self._struct == "RZ":
            return (p.nvars, p.b_rDim, p.zDim)
        return (p.nvars, p.b_rDim, self.kDim, p.zDim)

    @property
    def num_points(self) -> int:
        return int(np.prod(self.spatial_shape))

    @property
    def field_keys(self) -> tuple[str, ...]:
        # XYZ reuses the RLZ slot names: dr/drr are d/dx, d2/dx2 and dl/dll
        # true d/dy, d2/dy2
        return {
            "R": ("val", "dr", "drr"),
            "RZ": ("val", "dr", "drr", "dz", "dzz"),
            "RL": ("val", "dr", "drr", "dl", "dll"),
            "RLZ": ("val", "dr", "drr", "dl", "dll", "dz", "dzz"),
        }[self._struct]

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    def _y_points(self) -> np.ndarray:
        p = self.params
        return p.ymin + (p.ymax - p.ymin) * np.arange(self.nl) / self.nl

    # ------------------------------------------------------------------
    def coords(self) -> dict[str, torch.Tensor]:
        """Coordinate tensors broadcastable against ``[*spatial]`` fields.
        XYZ grids give "x"/"y"/"z" and SL/SLZ grids "lat"/"lon"(/"z"), each
        with "r" (and "l") as aliases, so the options of build_step that
        read the outer boundary work on them unchanged."""
        r = self._tensor(self.r_mish)
        g = self.geometry
        out: dict[str, torch.Tensor] = {}
        if g == "R":
            out["r"] = r
        elif g in ("RL", "SL"):
            out["r"] = r[:, None]
            out["l"] = self._tensor(fourier.angles(self.nl))[None, :]
        elif g == "RZ":
            out["r"] = r[:, None]
            out["z"] = self._tensor(self.z_mish)[None, :]
        elif g == "XYZ":
            out["r"] = out["x"] = r[:, None, None]
            out["y"] = self._tensor(self._y_points())[None, :, None]
            out["z"] = self._tensor(self.z_mish)[None, None, :]
        else:
            out["r"] = r[:, None, None]
            out["l"] = self._tensor(fourier.angles(self.nl))[None, :, None]
            out["z"] = self._tensor(self.z_mish)[None, None, :]
        if g in ("SL", "SLZ"):
            out["lat"], out["lon"] = out["r"], out["l"]
        return out

    def gridpoints(self) -> np.ndarray:
        """Reference-style [npoints, ndims] coordinate matrix (row order =
        flattened field order)."""
        if self.geometry == "R":
            return self.r_mish[:, None]
        if self.geometry in ("RL", "SL"):
            lam = fourier.angles(self.nl)
            rr, ll = np.meshgrid(self.r_mish, lam, indexing="ij")
            return np.stack([rr.ravel(), ll.ravel()], axis=1)
        if self.geometry == "RZ":
            rr, zz = np.meshgrid(self.r_mish, self.z_mish, indexing="ij")
            return np.stack([rr.ravel(), zz.ravel()], axis=1)
        lam = self._y_points() if self.geometry == "XYZ" else fourier.angles(self.nl)
        rr, ll, zz = np.meshgrid(self.r_mish, lam, self.z_mish, indexing="ij")
        return np.stack([rr.ravel(), ll.ravel(), zz.ravel()], axis=1)

    # ------------------------------------------------------------------
    def _l_coeffs(self, phys: torch.Tensor) -> torch.Tensor:
        """values -> masked real Fourier coefficients along the lambda axis
        (axis 2 of [nvars, rDim, nl, ...])."""
        if phys.ndim == 3:
            hat = self._mm("kl,vrl->vrk", self.l_analysis, phys)
            return hat * self.ring_mask[None, :, :]
        hat = self._mm("kl,vrlz->vrkz", self.l_analysis, phys)
        return hat * self.ring_mask[None, :, :, None]

    def _analysis_with(self, radial_op, radial_subs: str, phys: torch.Tensor):
        """The lambda transform first (its ring mask depends on r, so it runs
        while r is physical), then the radial contraction, then the vertical
        analysis: the JAX package's order."""
        g = self._struct
        if g == "R":
            return self._mm(radial_subs + ",vr->vb", radial_op, phys)
        if g == "RL":
            return self._mm(radial_subs + ",vrk->vbk", radial_op, self._l_coeffs(phys))
        if g == "RZ":
            rc = self._mm(radial_subs + ",vrz->vbz", radial_op, phys)
            return self._mm("vKz,vbz->vbK", self.analysis_z, rc)
        rc = self._mm(radial_subs + ",vrkz->vbkz", radial_op, self._l_coeffs(phys))
        return self._mm("vKz,vbkz->vbkK", self.analysis_z, rc)

    def analysis(self, phys: torch.Tensor) -> torch.Tensor:
        """physical [nvars, *spatial] -> spectral [nvars, b_rDim, ...].  On
        the RLZ structural class (RLZ, XYZ, SLZ) the whole chain is
        ``ops.rlz_analysis``: the CUDA kernel for tensors on the card, its
        plain einsum version on the CPU.  The kernel takes the grid's own
        DFT, ring mask and radial and vertical operators, so XYZ (a uniform
        2/3-rule mask) and SLZ (the a cos(lat) ring mask) are the same
        function at other shapes; the JAX package ran its fused TPU analysis
        on RLZ only, and this reach is a choice of implementation.  The
        wrapper's autograd Function carries the graph (backward, jvp, and a
        vmap rule that takes every member in one launch)."""
        if self._struct == "RLZ":
            if phys.device.type == "cuda":
                # the kernel reads row-major; a field computed from the
                # synthesis' einsum outputs may carry their permuted strides
                phys = phys.contiguous()
            return rlz_analysis.rlz_analysis(
                phys, self.l_analysis, self.ring_mask, self.analysis_r, self.analysis_z
            )
        return self._analysis_with(self.analysis_r, "vbr", phys)

    def project(self, phys: torch.Tensor) -> torch.Tensor:
        """Local radial quadrature projection; ``solve_spectral`` of the sum
        of projections over radial pieces equals ``analysis``."""
        return self._analysis_with(self.project_r, "br", phys)

    def solve_spectral(self, proj: torch.Tensor) -> torch.Tensor:
        return self._mm("vbc,vc...->vb...", self.msolve_r, proj)

    def synthesis(self, spec: torch.Tensor) -> dict[str, torch.Tensor]:
        """spectral -> all physical derivative slots, as a dict of
        ``[nvars, *spatial]`` tensors.  The vertical and azimuthal operators
        run on the compact coefficient block first and the radial expansion
        last, as in the JAX package."""
        g = self._struct
        out: dict[str, torch.Tensor] = {}
        if g == "R":
            r3 = self._mm("drb,vb->vdr", self.synth_r, spec)
            out["val"], out["dr"], out["drr"] = r3[:, 0], r3[:, 1], r3[:, 2]
            return out
        if g == "RL":
            lc = self._mm("dlk,vbk->vdbl", self.l_all, spec)
            r3 = self._mm("drb,vbl->vdrl", self.synth_r, lc[:, 0])
            rd = self._mm("rb,vdbl->vdrl", self.synth_r_val, lc[:, 1:])
            out["val"], out["dr"], out["drr"] = r3[:, 0], r3[:, 1], r3[:, 2]
            out["dl"], out["dll"] = rd[:, 0], rd[:, 1]
            return out
        if g == "RZ":
            zc = self._mm("dzK,vbK->vdbz", self.z_all, spec)
            r3 = self._mm("drb,vbz->vdrz", self.synth_r, zc[:, 0])
            rd = self._mm("rb,vdbz->vdrz", self.synth_r_val, zc[:, 1:])
            out["val"], out["dr"], out["drr"] = r3[:, 0], r3[:, 1], r3[:, 2]
            out["dz"], out["dzz"] = rd[:, 0], rd[:, 1]
            return out
        zc = self._mm("dzK,vbkK->vdbkz", self.z_all, spec)
        lv = self._mm("dlk,vbkz->vdblz", self.l_all, zc[:, 0])
        lz = self._mm("lk,vdbkz->vdblz", self.l_synth, zc[:, 1:])
        r3 = self._mm("drb,vblz->vdrlz", self.synth_r, lv[:, 0])
        rl = self._mm("rb,vdblz->vdrlz", self.synth_r_val, lv[:, 1:])
        rz = self._mm("rb,vdblz->vdrlz", self.synth_r_val, lz)
        out["val"], out["dr"], out["drr"] = r3[:, 0], r3[:, 1], r3[:, 2]
        out["dl"], out["dll"] = rl[:, 0], rl[:, 1]
        out["dz"], out["dzz"] = rz[:, 0], rz[:, 1]
        return out

    # ------------------------------------------------------------------
    # Chebyshev column helpers used inside equation sets, batched over all
    # columns: f has z on the LAST axis.
    def column_integrate(self, f: torch.Tensor) -> torch.Tensor:
        """Antiderivative in z anchored to 0 at z = zmin."""
        return self._mm("zk,...k->...z", self.zcol_int, f)

    def column_derivative(self, f: torch.Tensor) -> torch.Tensor:
        """d/dz of the R0-filtered column fit."""
        return self._mm("zk,...k->...z", self.zcol_deriv, f)

    def column_flux_derivative(self, f: torch.Tensor) -> torch.Tensor:
        """d/dz of a vertical flux with F = 0 imposed at the domain top."""
        return self._mm("zk,...k->...z", self.zcol_deriv_ftop, f)

    def column_filter(self, f: torch.Tensor) -> torch.Tensor:
        """Truncation round trip on columns."""
        return self._mm("zk,...k->...z", self.zcol_filter, f)


def create_grid(
    params: GridParameters,
    dtype: torch.dtype = torch.float32,
    matmul: str = "auto",
    device: Any = DEFAULT,
) -> Grid:
    """Build a grid and all of its transform operators on ``device`` (the
    card unless the caller asks for the CPU; raises without a card).

    ``matmul``: "plain" or "auto" run every operator in ``dtype``;
    "compensated" (the JAX package's bf16x3 TPU mode) is not ported."""
    p = params
    if p.geometry not in GEOMETRIES:
        raise ValueError(f"Unknown geometry {p.geometry!r}")
    if matmul == "compensated":
        raise NotImplementedError(
            "matmul='compensated' (bf16x3) is not ported to scythe_tpu_torch"
        )
    if matmul not in ("auto", "plain"):
        raise ValueError(f"matmul must be 'auto' or 'plain', got {matmul!r}")
    device = torch.device(device)
    if device.type == "cuda" and dtype == torch.float32 and (
        torch.backends.cuda.matmul.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        # TF32 keeps a 10-bit mantissa: like bf16 it ruins long spectral
        # integrations (docs/NUMERICS.md), so a float32 grid refuses it
        raise RuntimeError(
            "TF32 matmuls are enabled (torch.backends.cuda.matmul.allow_tf32 "
            "or set_float32_matmul_precision below 'highest'); the spectral "
            "transforms need full float32"
        )
    device = resolve_device(device)

    def prep(op):
        # contiguous: the RLZ analysis kernel reads the operators row-major
        return torch.as_tensor(np.ascontiguousarray(op), dtype=dtype, device=device)

    # --- radial spline operators, per variable BC pair ------------------
    an, ms = [], []
    for v in range(p.nvars):
        ops = bspline.build_ops(p.xmin, p.xmax, p.num_cells, p.BCL[v], p.BCR[v], p.l_q)
        an.append(ops.analysis)
        ms.append(ops.msolve)
    grid = Grid(
        params=p,
        dtype=dtype,
        device=device,
        r_mish=ops.mish,
        analysis_r=prep(np.stack(an)),
        project_r=prep(ops.project),
        msolve_r=prep(np.stack(ms)),
        synth_r=prep(ops.synth),
        synth_r_val=prep(ops.synth[0]),
    )

    def lon_ops(nl, axis, deriv_scale=1.0):
        """The dense real-DFT operators of a periodic axis (the JAX package's
        _dense_lon_ops): ``deriv_scale`` turns d/dlambda into a coordinate
        derivative (XYZ: 2 pi / Ly, d/dy) in ld and ld2, never in la."""
        if nl > _DENSE_NL_MAX:
            raise NotImplementedError(
                f"{axis}: nl = {nl} > {_DENSE_NL_MAX} needs the factored DFT "
                "(basis/fourier_factored.py), not ported to scythe_tpu_torch yet "
                "(ROADMAP item 8c)"
            )
        grid.nl = grid.kDim = nl
        la, ls, ld, ld2 = fourier.dft_matrices(nl)
        if deriv_scale != 1.0:
            ld = ld * deriv_scale
            ld2 = ld2 * (deriv_scale * deriv_scale)
        grid.l_analysis = prep(la)
        grid.l_synth = prep(ls)
        grid.l_all = prep(np.stack([ls, ld, ld2]))

    # --- periodic Cartesian y (XYZ box) ---------------------------------
    if p.geometry == "XYZ":
        if not p.lDim or p.lDim % 2:
            raise ValueError("XYZ grids need an explicit even lDim (y points)")
        if p.ymax <= p.ymin:
            raise ValueError("XYZ grids need ymax > ymin")
        nl = p.lDim
        lon_ops(nl, "XYZ y", deriv_scale=2.0 * np.pi / (p.ymax - p.ymin))
        # the uniform 2/3-rule dealias mask, every "ring" alike
        row = (fourier.coeff_wavenumbers(nl) <= max(nl // 3, 1)).astype(np.float64)
        grid.ring_mask = prep(np.tile(row, (p.rDim, 1)))

    # --- spherical longitude (SL / SLZ shells) --------------------------
    if p.geometry in ("SL", "SLZ"):
        if not p.lDim or p.lDim % 2:
            raise ValueError("SL/SLZ grids need an explicit even lDim (lon points)")
        if not (p.xmax > p.xmin and abs(p.xmin) <= np.pi / 2 + 1e-9
                and abs(p.xmax) <= np.pi / 2 + 1e-9):
            raise ValueError(
                f"SL/SLZ latitude bounds must be RADIANS within [-pi/2, pi/2], "
                f"got [{p.xmin}, {p.xmax}] (degrees by mistake?)"
            )
        nl = p.lDim
        lon_ops(nl, "SL/SLZ longitude")
        # the ring radius a cos(lat) plays the part r plays on the polar
        # grids: each ring keeps the zonal modes its circumference resolves
        a_sph = p.sphere_radius
        dphi = (p.xmax - p.xmin) / p.num_cells
        grid.ring_mask = prep(fourier.ring_coeff_mask(
            a_sph * np.cos(ops.mish), a_sph * dphi, nl, p.l_q))

    # --- azimuthal ------------------------------------------------------
    if p.geometry in ("RL", "RLZ"):
        nl = fourier.default_nl(p.num_cells, p.lDim)
        lon_ops(nl, "azimuth")
        dr = (p.xmax - p.xmin) / p.num_cells
        grid.ring_mask = prep(fourier.ring_coeff_mask(ops.mish, dr, nl, p.l_q))

    # --- vertical -------------------------------------------------------
    if p.geometry in ("RZ", "RLZ", "XYZ", "SLZ"):
        if p.zDim < 4:
            raise ValueError("zDim must be >= 4 for RZ/RLZ/XYZ/SLZ grids")
        anz = []
        for v in range(p.nvars):
            zops = chebyshev.build_ops(p.zDim, p.zmin, p.zmax, p.b_zDim, p.BCB[v], p.BCT[v])
            anz.append(zops.constrain @ zops.analysis)
        z0 = chebyshev.build_ops(p.zDim, p.zmin, p.zmax, p.b_zDim)
        grid.z_mish = z0.points
        grid.analysis_z = prep(np.stack(anz))
        grid.z_all = prep(np.stack([z0.synth, z0.dsynth, z0.d2synth]))
        r0a = z0.constrain @ z0.analysis
        grid.zcol_int = prep(z0.isynth @ r0a)
        grid.zcol_deriv = prep(z0.dsynth @ r0a)
        grid.zcol_filter = prep(z0.synth @ r0a)
        # F = 0 at the top for the rain sedimentation flux (nothing falls in
        # from above); see the JAX package's create_grid for the measured
        # instability the unconstrained fit gives there
        zf = chebyshev.build_ops(
            p.zDim, p.zmin, p.zmax, p.b_zDim, chebyshev.ZBC.R0, chebyshev.ZBC.R1T0
        )
        grid.zcol_deriv_ftop = prep(z0.dsynth @ (zf.constrain @ zf.analysis))
    return grid
