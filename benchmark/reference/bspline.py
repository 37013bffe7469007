"""Frozen copy of ``scythe_tpu_torch/basis/bspline.py`` for the benchmark's plain
reference (imports rewritten; it imports nothing of the port).

Copied verbatim from ``scythe_tpu.basis.bspline`` (numpy only, so the port can
import it without jax); tests/test_torch_basis.py pins every operator
array-equal to the original.

Cubic B-spline radial basis (Ooyama-style spectral finite elements).

This is a from-scratch, TPU-first reconstruction of the radial basis layer of
the reference semi-spectral core (Scythe.jl / its un-vendored Springsteel
dependency; API contract pinned at reference call sites, e.g.
src/spectralGrid.jl:20-45 and src/semiimplicit.jl:301-332).

Semantics
---------
* Uniform knots over ``[xmin, xmax]`` with ``num_cells`` cells of width
  ``dx``; the basis is the ``num_cells + 3`` cubic B-splines whose centers
  are the nodes ``-1 .. num_cells+1`` (reference: ``b_rDim = num_cells + 3``,
  spectralGrid.jl:27).
* Physical collocation points are the "mish" points: ``mubar = 3`` points per
  cell (reference: ``rDim = num_cells * mubar``, spectralGrid.jl:25-26).  We
  place them at the 3-point Gauss-Legendre abscissae of each cell, which
  makes the analysis an exact weighted least-squares projection (any function
  already in the spline space round-trips to machine precision).
* Analysis (physical -> spectral) is the filtered least-squares projection

      a = T (Phi_c^T W Phi_c + eps * P)^{-1} Phi_c^T W f

  where ``T`` is the boundary-condition basis-recombination matrix (Ooyama
  Rn-Tm constrained families), ``W`` the Gauss weights, and ``P`` a
  third-derivative penalty implementing the spline low-pass filter with
  half-power cutoff at wavelength ``l_q * dx`` (reference: ``l_q = 2.0``,
  spectralGrid.jl:28).
* The projection ``p = Phi^T W f`` is a *local* quadrature sum over cells,
  which is what makes radial domain decomposition an exact overlap-add of
  partial projections (the TPU-native analog of the reference halo exchange,
  semiimplicit.jl:320-329).

Everything here is precomputed once per grid in float64 numpy; the runtime
transform path applies the resulting dense operators as (batched) matmuls on
the MXU.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

MUBAR = 3  # mish (collocation) points per cell, ref spectralGrid.jl:25

# 3-point Gauss-Legendre rule on [0, 1]
_GAUSS_X = np.array(
    [0.5 - 0.5 * np.sqrt(3.0 / 5.0), 0.5, 0.5 + 0.5 * np.sqrt(3.0 / 5.0)]
)
_GAUSS_W = np.array([5.0 / 18.0, 8.0 / 18.0, 5.0 / 18.0])


class BC(enum.Enum):
    """Boundary-condition families for the constrained spline basis.

    Ooyama-style Rn-Tm families (reference usage:
    models/cha_bell2024/Twoway_ShallowWater_Slab.jl:13-26):
      R0    -- no boundary constraint
      R1T0  -- f  = 0 at the boundary (one exterior basis fn removed)
      R1T1  -- f' = 0 at the boundary
      R1T2  -- f'' = 0 at the boundary
      R2T10 -- f = f' = 0
      R2T20 -- f = f'' = 0
      R3    -- f = f' = f'' = 0
      PERIODIC -- periodic wrap (must be used on both ends)
    """

    R0 = "R0"
    R1T0 = "R1T0"
    R1T1 = "R1T1"
    R1T2 = "R1T2"
    R2T10 = "R2T10"
    R2T20 = "R2T20"
    R3 = "R3"
    PERIODIC = "PERIODIC"


def _bspline_piece(t: np.ndarray, deriv: int) -> np.ndarray:
    """Cardinal cubic B-spline b(t) (support |t| < 2) and derivatives."""
    at = np.abs(t)
    s = np.sign(t)
    outer = (at >= 1.0) & (at < 2.0)
    inner = at < 1.0
    out = np.zeros_like(t)
    if deriv == 0:
        out = np.where(outer, (2.0 - at) ** 3 / 6.0, out)
        out = np.where(inner, 2.0 / 3.0 - at**2 + at**3 / 2.0, out)
    elif deriv == 1:
        out = np.where(outer, -s * (2.0 - at) ** 2 / 2.0, out)
        out = np.where(inner, -2.0 * t + 1.5 * t * at, out)
    elif deriv == 2:
        out = np.where(outer, 2.0 - at, out)
        out = np.where(inner, -2.0 + 3.0 * at, out)
    elif deriv == 3:
        out = np.where(outer, -s, out)
        out = np.where(inner, 3.0 * s, out)
    else:
        raise ValueError(f"deriv {deriv} not supported")
    return out


def mish_points(xmin: float, xmax: float, num_cells: int) -> np.ndarray:
    """The ``3 * num_cells`` Gauss collocation ("mish") points, ascending."""
    dx = (xmax - xmin) / num_cells
    cells = np.arange(num_cells)[:, None]
    pts = xmin + (cells + _GAUSS_X[None, :]) * dx
    return pts.reshape(-1)


def mish_weights(xmin: float, xmax: float, num_cells: int) -> np.ndarray:
    dx = (xmax - xmin) / num_cells
    return np.tile(_GAUSS_W * dx, num_cells)


def collocation_matrix(
    xmin: float, xmax: float, num_cells: int, x: np.ndarray, deriv: int = 0
) -> np.ndarray:
    """Dense [len(x), num_cells+3] matrix of basis (derivative) values.

    Basis function j (0-based) is centered at node ``j - 1``.
    """
    dx = (xmax - xmin) / num_cells
    centers = xmin + (np.arange(num_cells + 3) - 1.0) * dx
    t = (x[:, None] - centers[None, :]) / dx
    return _bspline_piece(t, deriv) / dx**deriv


def _constraint_left(bc: BC) -> tuple[int, np.ndarray]:
    """Columns (in terms of raw basis index 0..) for the left-end recombined
    basis functions touching the boundary.  Returns (n_removed, block) where
    block has shape [3, 3 - n_removed] giving the first three raw
    coefficients of the first ``3 - n_removed`` constrained functions.

    Derivation: with f(x0) = (a0 + a2)/6 + (2/3) a1, f'(x0) = (a2 - a0)/2dx,
    f''(x0) = (a0 - 2 a1 + a2)/dx^2 for raw coefficients a0.. of splines
    centered at nodes -1, 0, 1.
    """
    eye = np.eye(3)
    if bc == BC.R0:
        return 0, eye
    if bc == BC.R1T0:  # a0 = -4 a1 - a2
        return 1, np.array([[-4.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
    if bc == BC.R1T1:  # a0 = a2
        return 1, np.array([[0.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    if bc == BC.R1T2:  # a0 = 2 a1 - a2
        return 1, np.array([[2.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
    if bc == BC.R2T10:  # a0 = a2, a1 = -a2/2
        return 2, np.array([[1.0], [-0.5], [1.0]])
    if bc == BC.R2T20:  # a1 = 0, a0 = -a2
        return 2, np.array([[-1.0], [0.0], [1.0]])
    if bc == BC.R3:
        return 3, np.zeros((3, 0))
    raise ValueError(f"bad left BC {bc}")


def constraint_matrix(num_cells: int, bcl: BC, bcr: BC) -> np.ndarray:
    """The [num_cells+3, K] basis-recombination matrix T (a = T c)."""
    nb = num_cells + 3
    if (bcl == BC.PERIODIC) != (bcr == BC.PERIODIC):
        raise ValueError("PERIODIC must be set on both ends")
    if bcl == BC.PERIODIC:
        T = np.zeros((nb, num_cells))
        for j in range(nb):
            T[j, (j - 1) % num_cells] = 1.0
        return T
    nl, bl = _constraint_left(bcl)
    nr, br = _constraint_left(bcr)
    k = nb - nl - nr
    T = np.zeros((nb, k))
    kl = 3 - nl  # constrained fns touching the left boundary
    kr = 3 - nr
    T[0:3, 0:kl] = bl
    # mirror the right block: raw index nb-1-i pairs with left raw index i
    T[nb - 3 : nb, k - kr : k] = br[::-1, ::-1]
    for j in range(3, nb - 3):
        T[j, kl + (j - 3)] = 1.0
    return T


@dataclass(frozen=True)
class BSplineOps:
    """Precomputed dense operators for one (grid, BC pair) combination.

    a = msolve @ p  where p = phi^T W f is the local quadrature projection;
    full analysis  a = analysis @ f ; synthesis value/derivs f_d = synth[d] @ a.
    """

    xmin: float
    xmax: float
    num_cells: int
    mish: np.ndarray  # [3n]
    weights: np.ndarray  # [3n]
    project: np.ndarray  # [nb, 3n]  (phi^T W  -- local, decomposable)
    msolve: np.ndarray  # [nb, nb]
    analysis: np.ndarray  # [nb, 3n]
    synth: np.ndarray  # [3, 3n, nb]  (value, d/dr, d2/dr2)
    # Constrained-space pieces, exposed for the distributed (Schur) solve
    # (parallel/schur.py): a = T @ inv(mmat) @ T.T @ p.
    T: np.ndarray = None  # [nb, K] basis-recombination
    mmat: np.ndarray = None  # [K, K] gram + filter (banded, hbw 3)


@lru_cache(maxsize=None)
def build_ops(
    xmin: float,
    xmax: float,
    num_cells: int,
    bcl: BC,
    bcr: BC,
    l_q: float = 2.0,
) -> BSplineOps:
    """Build all dense operators for one radial basis configuration."""
    dx = (xmax - xmin) / num_cells
    x = mish_points(xmin, xmax, num_cells)
    w = mish_weights(xmin, xmax, num_cells)
    phi = [collocation_matrix(xmin, xmax, num_cells, x, d) for d in range(3)]
    T = constraint_matrix(num_cells, bcl, bcr)
    phic = phi[0] @ T

    # Third-derivative filter penalty, half-power at wavelength l_q*dx.
    # phi''' is piecewise constant per cell: evaluate at cell midpoints.
    mids = xmin + (np.arange(num_cells) + 0.5) * dx
    p3 = collocation_matrix(xmin, xmax, num_cells, mids, 3) @ T
    if bcl == BC.PERIODIC:
        # periodic images: third derivative of wrapped basis
        p3 = p3  # collocation_matrix already only covers centers in range;
        # wrapped basis is the column sum via T, consistent with phic.
    pen = dx * (p3.T @ p3)
    eps = (l_q * dx / (2.0 * np.pi)) ** 6 if l_q > 0 else 0.0

    gram = phic.T @ (w[:, None] * phic)
    m = gram + eps * pen
    minv = np.linalg.inv(m)
    msolve = T @ minv @ T.T
    project = phi[0].T * w[None, :]
    analysis = msolve @ project
    synth = np.stack(phi, axis=0)
    return BSplineOps(
        xmin=xmin,
        xmax=xmax,
        num_cells=num_cells,
        mish=x,
        weights=w,
        project=project,
        msolve=msolve,
        analysis=analysis,
        synth=synth,
        T=T,
        mmat=m,
    )
