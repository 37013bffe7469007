"""Grid objects: mixed-basis spectral transforms on the reference's four
geometries (R / RL / RZ / RLZ) and the JAX package's XYZ Cartesian box and
SL / SLZ spherical shells, in PyTorch.

The counterpart of ``scythe_tpu.grids.base``, with every transform mode of
its ``Grid``:

* Physical state is a dense tensor ``[nvars, rDim(, nl)(, nz)]``; vertical
  columns and azimuthal rings are batch axes, and z is always the last
  axis.
* Analysis / synthesis are precomputed dense operators (built in float64
  numpy by ``basis/``, cast once to the grid's dtype and device) applied
  through ``Grid._mm``: cubic B-splines in r, real-DFT matrices with a
  per-ring wavenumber mask in lambda, Chebyshev (dense DCT matrices) in z.
  These are plain GEMMs; the JAX package also leaves them to the compiler.
  The analysis of the RLZ structural class (RLZ, XYZ, SLZ) with the dense
  DFT is the exception: on the card it is one hand-written CUDA kernel
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

Matmul modes, as in the JAX package (``create_grid(matmul=...)``):

* "plain": every operator in the grid's dtype (true FP32 or FP64; a float32
  grid on the card refuses TF32).
* "compensated": the JAX package's bf16x3 TPU numerics.  Every operator O
  is stored as the stack [O_hi, O_lo, O_hi] (O_hi = bf16(O), O_lo =
  bf16(O - O_hi), both rounded to nearest even) and every activation x is
  stacked [x_hi, x_hi, x_lo], so one GEMM contracting the stack axis gives
  O_hi x_hi + O_lo x_hi + O_hi x_lo.  The bf16 values are held in the
  grid's dtype and multiplied in it: a product of two bf16 values is exact
  in float32, so this is the function the TPU's bf16 x bf16 -> f32 matrix
  unit computes.  Eager PyTorch never folds the f32 -> bf16 -> f32 round
  trip of the split (the JAX package needs an optimization barrier for
  that under XLA); the port runs no torch.compile.
* ``deriv_single`` (compensated grids only, off on R and factored grids;
  auto means on): the value chain of ``synthesis`` stays compensated and
  the six derivative slots take single-pass bf16 GEMMs with f32
  accumulation (``fast``).
* "auto" is plain on the card and on the CPU; the JAX package's auto means
  compensated on the TPU only.

The periodic axis takes the radix-split (factored) DFT of
``basis/fourier_factored.py`` where ``GridParameters.l_factored`` asks for
it, or by default above 2048 points where nl has an even x even
factorisation; its spectral layout is the K_f slots of that module
(``kDim``), not nl.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..basis import bspline, chebyshev, fourier
from ..basis import fourier_factored as ff
from ..config import GridParameters
from ..device import DEFAULT, resolve_device
from ..ops import rlz_analysis
from ..ops.bf16x3 import bf16_round, comp_einsum, split_op

GEOMETRIES = ("R", "RL", "RZ", "RLZ", "XYZ", "SL", "SLZ")
# auto takes the factored DFT above this many points (the JAX package's rule)
_DENSE_NL_MAX = 2048


def _split3(op: np.ndarray) -> torch.Tensor:
    """[O_hi, O_lo, O_hi] bfloat16 stack of ``op`` for the compensated GEMM,
    bit for bit the JAX package's _split3: op rounded to float32, then hi =
    bf16(o32) and lo = bf16(o32 - hi), each to nearest even."""
    o32 = torch.from_numpy(np.ascontiguousarray(np.asarray(op, np.float32)))
    return split_op(o32).to(torch.bfloat16)


def _bf16(op: np.ndarray) -> torch.Tensor:
    """Plain bfloat16 operator for the single-pass derivative GEMMs."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(op, np.float32))).to(
        torch.bfloat16)


@dataclass
class Grid:
    """A built grid: static metadata + operator tensors on one device."""

    params: GridParameters
    dtype: torch.dtype
    device: torch.device
    comp: bool  # compensated bf16x3: every operator a [3, ...] stack
    # radial operators
    r_mish: np.ndarray  # [rDim] (host, float64)
    analysis_r: torch.Tensor  # [nvars, nb, rDim]
    project_r: torch.Tensor  # [nb, rDim]
    msolve_r: torch.Tensor  # [nvars, nb, nb]
    synth_r: torch.Tensor  # [3, rDim, nb]
    synth_r_val: torch.Tensor  # [rDim, nb]
    # azimuthal (real DFT; the spectral state holds lambda coefficients)
    nl: int = 0
    kDim: int = 0  # azimuthal spectral slots (nl dense; fd.K factored)
    ring_mask: torch.Tensor | None = None  # [rDim, kDim] over coefficient slots
    l_analysis: torch.Tensor | None = None  # [nl, nl] values -> coeffs
    l_synth: torch.Tensor | None = None  # [nl, nl] coeffs -> values
    l_all: torch.Tensor | None = None  # [3, nl, nl] coeffs -> (val, dl, dll)
    l_fact: Any = None  # fourier_factored.FactOps (radix-split mode)
    # vertical
    z_mish: np.ndarray | None = None  # [nz]
    analysis_z: torch.Tensor | None = None  # [nvars, nz, nz]
    z_all: torch.Tensor | None = None  # [3, nz, nz] coeff -> (val, dz, dzz)
    zcol_int: torch.Tensor | None = None
    zcol_deriv: torch.Tensor | None = None
    zcol_filter: torch.Tensor | None = None
    zcol_deriv_ftop: torch.Tensor | None = None
    # selective single-pass bf16 derivative synthesis (fast=True, the JAX
    # package's deriv_single): the value chain stays compensated (its errors
    # feed analysis and accumulate), the six derivative slots take one bf16
    # pass (they enter the state only through tendencies x dt)
    fast: bool = False
    z_synth_val: torch.Tensor | None = None  # [nz, nz] value only
    z_deriv_f: torch.Tensor | None = None  # bf16-valued [2, nz, nz] (dz, dzz)
    l_deriv_f: torch.Tensor | None = None  # bf16-valued [2, nl, nl] (dl, dll)
    l_synth_f: torch.Tensor | None = None  # bf16-valued [nl, nl]
    synth_r_deriv_f: torch.Tensor | None = None  # bf16-valued [2, rDim, nb]
    synth_r_val_f: torch.Tensor | None = None  # bf16-valued [rDim, nb]

    def _mm(self, subs: str, op: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Apply a stored operator: a plain einsum, or on a compensated grid
        the bf16x3 GEMM over the operator's [3, ...] stack."""
        if not self.comp:
            return torch.einsum(subs, op, x)
        return comp_einsum(subs, op, x)

    def _mmf(self, subs: str, op: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Single-pass bf16 GEMM (a bf16-valued operator, x rounded to bf16)
        accumulated in the grid's dtype: the derivative slots."""
        return torch.einsum(subs, op, bf16_round(x))

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

    def slot_wavenumbers(self) -> np.ndarray:
        """|k| of each azimuthal spectral slot (kDim of them): the dense
        layout's coefficient wavenumbers, or the factored layout's (0 at its
        invalid slots), as the JAX package's modal filter reads them."""
        if self.l_fact is not None:
            return np.sqrt(np.maximum(-np.asarray(self.l_fact.fd.k_d2), 0.0))
        return np.abs(fourier.coeff_wavenumbers(self.nl)).astype(np.float64)

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
            if self.l_fact is not None:
                hat = ff.analysis_mm(self.l_fact, self._mm, phys, with_z=False)
            else:
                hat = self._mm("kl,vrl->vrk", self.l_analysis, phys)
            return hat * self.ring_mask[None, :, :]
        if self.l_fact is not None:
            hat = ff.analysis_mm(self.l_fact, self._mm, phys, with_z=True)
        else:
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
        the RLZ structural class (RLZ, XYZ, SLZ) with the dense DFT the whole
        chain is ``ops.rlz_analysis``: the CUDA kernel for tensors on the
        card, its plain version on the CPU; on a compensated grid its
        compensated mode (bf16x3 contractions, the activation re-split after
        every stage, as the TPU kernel), else the plain f32/f64 mode.  The
        kernel takes the grid's own DFT, ring mask and radial and vertical
        operators, so XYZ (a uniform 2/3-rule mask) and SLZ (the a cos(lat)
        ring mask) are the same function at other shapes; the JAX package
        ran its fused TPU analysis on RLZ only, and this reach is a choice of
        implementation.  A factored-DFT grid takes the einsum chain by
        design: the TPU kernel, too, takes the dense DFT only
        (``rlz_analysis_supported`` asks ``l_fact is None``).  The wrapper's
        autograd Function carries the graph (backward, jvp, and a vmap rule
        that takes every member in one launch)."""
        if self._struct == "RLZ" and self.l_fact is None:
            if phys.device.type == "cuda":
                # the kernel reads row-major; a field computed from the
                # synthesis' einsum outputs may carry their permuted strides
                phys = phys.contiguous()
            return rlz_analysis.rlz_analysis(
                phys, self.l_analysis, self.ring_mask, self.analysis_r, self.analysis_z,
                "comp" if self.comp else "plain",
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
            if self.fast:
                lval = self._mm("lk,vbk->vbl", self.l_synth, spec)
                ld = self._mmf("dlk,vbk->vdbl", self.l_deriv_f, spec)
                rdv = self._mmf("drb,vbl->vdrl", self.synth_r_deriv_f, lval)
                rd = self._mmf("rb,vdbl->vdrl", self.synth_r_val_f, ld)
                out["val"] = self._mm("rb,vbl->vrl", self.synth_r_val, lval)
                out["dr"], out["drr"] = rdv[:, 0], rdv[:, 1]
                out["dl"], out["dll"] = rd[:, 0], rd[:, 1]
                return out
            if self.l_fact is not None:
                lc = ff.synthesis_mm(self.l_fact, self._mm, spec, (0, 1, 2), False)
            else:
                lc = self._mm("dlk,vbk->vdbl", self.l_all, spec)
            r3 = self._mm("drb,vbl->vdrl", self.synth_r, lc[:, 0])
            rd = self._mm("rb,vdbl->vdrl", self.synth_r_val, lc[:, 1:])
            out["val"], out["dr"], out["drr"] = r3[:, 0], r3[:, 1], r3[:, 2]
            out["dl"], out["dll"] = rd[:, 0], rd[:, 1]
            return out
        if g == "RZ":
            if self.fast:
                zval = self._mm("zK,vbK->vbz", self.z_synth_val, spec)
                zd = self._mmf("dzK,vbK->vdbz", self.z_deriv_f, spec)
                rdv = self._mmf("drb,vbz->vdrz", self.synth_r_deriv_f, zval)
                rd = self._mmf("rb,vdbz->vdrz", self.synth_r_val_f, zd)
                out["val"] = self._mm("rb,vbz->vrz", self.synth_r_val, zval)
                out["dr"], out["drr"] = rdv[:, 0], rdv[:, 1]
                out["dz"], out["dzz"] = rd[:, 0], rd[:, 1]
                return out
            zc = self._mm("dzK,vbK->vdbz", self.z_all, spec)
            r3 = self._mm("drb,vbz->vdrz", self.synth_r, zc[:, 0])
            rd = self._mm("rb,vdbz->vdrz", self.synth_r_val, zc[:, 1:])
            out["val"], out["dr"], out["drr"] = r3[:, 0], r3[:, 1], r3[:, 2]
            out["dz"], out["dzz"] = rd[:, 0], rd[:, 1]
            return out
        if self.fast:
            zval = self._mm("zK,vbkK->vbkz", self.z_synth_val, spec)
            zd = self._mmf("dzK,vbkK->vdbkz", self.z_deriv_f, spec)
            lval = self._mm("lk,vbkz->vblz", self.l_synth, zval)
            ld = self._mmf("dlk,vbkz->vdblz", self.l_deriv_f, zval)
            lz = self._mmf("lk,vdbkz->vdblz", self.l_synth_f, zd)
            rdv = self._mmf("drb,vblz->vdrlz", self.synth_r_deriv_f, lval)
            rl = self._mmf("rb,vdblz->vdrlz", self.synth_r_val_f, ld)
            rz = self._mmf("rb,vdblz->vdrlz", self.synth_r_val_f, lz)
            out["val"] = self._mm("rb,vblz->vrlz", self.synth_r_val, lval)
            out["dr"], out["drr"] = rdv[:, 0], rdv[:, 1]
            out["dl"], out["dll"] = rl[:, 0], rl[:, 1]
            out["dz"], out["dzz"] = rz[:, 0], rz[:, 1]
            return out
        zc = self._mm("dzK,vbkK->vdbkz", self.z_all, spec)
        if self.l_fact is not None:
            lv = ff.synthesis_mm(self.l_fact, self._mm, zc[:, 0], (0, 1, 2), True)
            nv = zc.shape[0]
            zd = zc[:, 1:].reshape((nv * 2,) + tuple(zc.shape[2:]))
            lz = ff.synthesis_mm(self.l_fact, self._mm, zd, (0,), True)
            lz = lz.reshape((nv, 2) + tuple(lz.shape[2:]))
        else:
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


def _pick_factored(p: GridParameters, nl: int) -> bool:
    """The factored-DFT decision for a periodic axis (the JAX package's
    rule): an explicit ``l_factored`` wins; auto takes it above nl = 2048
    where nl has an even x even split, and the dense DFT otherwise."""
    factored = p.l_factored
    if factored is None:
        factored = nl > _DENSE_NL_MAX
        if factored:
            try:
                ff.split_radix(nl)
            except ValueError:
                factored = False
    elif factored:
        ff.split_radix(nl)  # an unfactorable nl: raise the real reason
    return bool(factored)


def create_grid(
    params: GridParameters,
    dtype: torch.dtype = torch.float32,
    matmul: str = "auto",
    device: Any = DEFAULT,
) -> Grid:
    """Build a grid and all of its transform operators on ``device`` (the
    card unless the caller asks for the CPU; raises without a card).

    ``matmul``: "plain" runs every operator in ``dtype``; "compensated" is
    the JAX package's bf16x3 mode (the module docstring), with
    ``params.deriv_single`` choosing single-pass bf16 derivative slots;
    "auto" is plain on the card and on the CPU (the JAX package's auto is
    compensated on the TPU only).  A float32 grid on the card, compensated
    or not, refuses TF32."""
    p = params
    if p.geometry not in GEOMETRIES:
        raise ValueError(f"Unknown geometry {p.geometry!r}")
    if matmul not in ("auto", "plain", "compensated"):
        raise ValueError(
            f"matmul must be 'auto', 'plain' or 'compensated', got {matmul!r}"
        )
    comp = matmul == "compensated"
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

    def tensor(a):
        # contiguous: the RLZ analysis kernel reads the operators row-major
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    def prep(op):
        """An operator of a GEMM: in dtype, or the compensated stack."""
        if comp:
            return _split3(op).to(dtype=dtype, device=device)
        return tensor(op)

    def prep_f(op):
        """A single-pass bf16 operator, held in dtype."""
        return _bf16(op).to(dtype=dtype, device=device)

    # --- radial spline operators, per variable BC pair ------------------
    an, ms = [], []
    for v in range(p.nvars):
        ops = bspline.build_ops(p.xmin, p.xmax, p.num_cells, p.BCL[v], p.BCR[v], p.l_q)
        an.append(ops.analysis)
        ms.append(ops.msolve)
    synth = ops.synth
    grid = Grid(
        params=p,
        dtype=dtype,
        device=device,
        comp=comp,
        r_mish=ops.mish,
        analysis_r=prep(np.stack(an)),
        project_r=prep(ops.project),
        msolve_r=prep(np.stack(ms)),
        synth_r=prep(synth),
        synth_r_val=prep(synth[0]),
    )

    def lon_ops(nl, deriv_scale=1.0):
        """The real-DFT operators of a periodic axis: the factored DFT where
        _pick_factored takes it (returns its FactoredDFT), else the dense
        matrices (the JAX package's _dense_lon_ops; returns None).
        ``deriv_scale`` turns d/dlambda into a coordinate derivative (XYZ:
        2 pi / Ly, d/dy) in the derivative operators, never in analysis."""
        grid.nl = nl
        if _pick_factored(p, nl):
            fd = ff.FactoredDFT(nl)
            grid.l_fact = ff.FactOps(fd, prep, tensor, deriv_scale=deriv_scale)
            grid.kDim = fd.K
            return fd
        grid.kDim = nl
        la, ls, ld, ld2 = fourier.dft_matrices(nl)
        if deriv_scale != 1.0:
            ld = ld * deriv_scale
            ld2 = ld2 * (deriv_scale * deriv_scale)
        grid.l_analysis = prep(la)
        grid.l_synth = prep(ls)
        grid.l_all = prep(np.stack([ls, ld, ld2]))
        l_mats[:] = [ls, ld, ld2]
        return None

    l_mats: list = []  # the dense (ls, ld, ld2), for the fast derivatives

    # --- periodic Cartesian y (XYZ box) ---------------------------------
    if p.geometry == "XYZ":
        if not p.lDim or p.lDim % 2:
            raise ValueError("XYZ grids need an explicit even lDim (y points)")
        if p.ymax <= p.ymin:
            raise ValueError("XYZ grids need ymax > ymin")
        nl = p.lDim
        fd = lon_ops(nl, deriv_scale=2.0 * np.pi / (p.ymax - p.ymin))
        # the uniform 2/3-rule dealias mask, every "ring" alike
        if fd is not None:
            row = (fd.k_of_slot <= max(nl // 3, 1)) * fd.base_mask
        else:
            row = (fourier.coeff_wavenumbers(nl) <= max(nl // 3, 1)).astype(np.float64)
        grid.ring_mask = tensor(np.tile(row, (p.rDim, 1)))

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
        fd = lon_ops(nl)
        # the ring radius a cos(lat) plays the part r plays on the polar
        # grids: each ring keeps the zonal modes its circumference resolves
        a_sph = p.sphere_radius
        dphi = (p.xmax - p.xmin) / p.num_cells
        r_equiv = a_sph * np.cos(ops.mish)
        if fd is not None:
            grid.ring_mask = tensor(fd.ring_mask(r_equiv, a_sph * dphi, p.l_q))
        else:
            grid.ring_mask = tensor(
                fourier.ring_coeff_mask(r_equiv, a_sph * dphi, nl, p.l_q))

    # --- azimuthal ------------------------------------------------------
    if p.geometry in ("RL", "RLZ"):
        nl = fourier.default_nl(p.num_cells, p.lDim)
        fd = lon_ops(nl)
        dr = (p.xmax - p.xmin) / p.num_cells
        if fd is not None:
            grid.ring_mask = tensor(fd.ring_mask(ops.mish, dr, p.l_q))
        else:
            grid.ring_mask = tensor(fourier.ring_coeff_mask(ops.mish, dr, nl, p.l_q))

    # --- vertical -------------------------------------------------------
    z_mats = None
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
        grid.z_synth_val = prep(z0.synth)
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
        z_mats = (z0.dsynth, z0.d2synth)

    # --- selective single-pass bf16 derivative synthesis ----------------
    # auto: on in compensated mode (the JAX package validated it on the
    # flagship configuration, tools/validate_fastderiv.py); only meaningful
    # there, and the factored DFT keeps its own compensated chain
    fast_req = True if p.deriv_single is None else p.deriv_single
    if fast_req and comp and p.geometry != "R" and grid.l_fact is None:
        grid.fast = True
        grid.synth_r_deriv_f = prep_f(synth[1:])
        grid.synth_r_val_f = prep_f(synth[0])
        if l_mats:
            ls, ld, ld2 = l_mats
            grid.l_deriv_f = prep_f(np.stack([ld, ld2]))
            grid.l_synth_f = prep_f(ls)
        if z_mats is not None:
            grid.z_deriv_f = prep_f(np.stack(z_mats))
    return grid
