"""``options["modal_filter_tau"]`` (with ``modal_filter_axes``, "rlz" by
default, and ``modal_filter_order``, 4): the per-step modal filter of
``scythe_tpu_torch/model.py`` (``build_modal_filter``) on the closing
analysis's coefficients, exact exponential damping with e-folding time tau at
the grid scale, falling as (scale fraction)^order toward resolved scales:

- the B-spline axis, per variable: Q V exp(-(ts/tau) lam/lam_max) V^T Q^T,
  Q an orthonormal basis of the variable's boundary-condition subspace and
  (lam, V) the eigenpairs of the coefficients' fourth-difference energy on
  it (a periodic variable: the circulant operator, lifted as T F pinv(T));
  where the ring mask varies along the axis the factor is applied as
  synthesis, mask, re-analysis;
- the Fourier axis: exp(-(ts/tau) (|k|/kmax)^order) a wavenumber slot;
- the Chebyshev axis: exp(-(ts/tau) (n/nmax)^order) a mode.

Every operator is built in float64 numpy and cast once.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import bspline

STAGE = "filter"
ORDER = 0
PARAMS = ("modal_filter_axes", "modal_filter_order")


def _second_difference(n: int, periodic: bool) -> np.ndarray:
    d2 = np.zeros((n, n))
    for i in range(n) if periodic else range(1, n - 1):
        d2[i, i] = -2.0
        d2[i, (i - 1) % n] = 1.0
        d2[i, (i + 1) % n] = 1.0
    return d2


def radial_filter(p, v: int, a: float) -> np.ndarray:
    """[b_rDim, b_rDim] B-spline-axis factor of variable ``v``."""
    T = bspline.constraint_matrix(p.num_cells, p.BCL[v], p.BCR[v])
    if p.BCL[v] == bspline.BC.PERIODIC:
        d2 = _second_difference(p.num_cells, periodic=True)
        lam, vec = np.linalg.eigh(d2.T @ d2)
        core = (vec * np.exp(-a * np.clip(lam / lam.max(), 0.0, None))) @ vec.T
        return T @ core @ np.linalg.pinv(T)
    q, _ = np.linalg.qr(T)
    b = _second_difference(p.b_rDim, periodic=False) @ q
    lam, vec = np.linalg.eigh(b.T @ b)
    lmax = lam.max()
    if lmax <= 0.0:
        return q @ q.T
    core = (vec * np.exp(-a * np.clip(lam / lmax, 0.0, None))) @ vec.T
    return q @ core @ q.T


def build_modal_filter(grid, tau: float, order: int, ts: float, dtype, axes: str = "rlz"):
    """spec -> spec; ``axes`` names the filtered directions."""
    p = grid.params
    g = grid._struct
    a = ts / tau

    def tensor(o):
        return torch.as_tensor(np.asarray(o), dtype=dtype, device=grid.device)

    f_r = f_rk = None
    if "r" in axes:
        fs = [radial_filter(p, v, a) for v in range(p.nvars)]
        f_r = tensor(np.stack(fs))
        ring_mask = getattr(grid, "ring_mask", None)
        if ring_mask is not None:
            mask = ring_mask.detach().cpu().numpy().astype(np.float64)
            if not np.allclose(mask, mask[0][None, :]):
                a_ops, sf_ops = [], []
                for v in range(p.nvars):
                    ops = bspline.build_ops(p.xmin, p.xmax, p.num_cells, p.BCL[v], p.BCR[v],
                                            p.l_q)
                    a_ops.append(ops.analysis)  # [b_r, rDim]
                    sf_ops.append(ops.synth[0] @ fs[v])  # [rDim, b_r]
                f_rk = (tensor(np.stack(a_ops)), tensor(np.stack(sf_ops)), tensor(mask))
                f_r = None

    f_l = f_z = None
    if g in ("RL", "RLZ") and "l" in axes:
        k = grid.slot_wavenumbers()
        f_l = tensor(np.exp(-a * (k / max(k.max(), 1.0)) ** order))
    if g in ("RZ", "RLZ") and "z" in axes:
        n = np.arange(p.zDim, dtype=np.float64)
        f_z = tensor(np.exp(-a * (n / max(p.zDim - 1, 1)) ** order))

    def apply(spec):
        out = spec
        if f_r is not None:
            out = torch.einsum("vab,vb...->va...", f_r, out)
        elif f_rk is not None:
            a_st, sf_st, mk = f_rk
            if g == "RL":
                mid = torch.einsum("vrb,vbk->vrk", sf_st, out) * mk[None]
                out = torch.einsum("vbr,vrk->vbk", a_st, mid)
            else:
                mid = torch.einsum("vrb,vbkK->vrkK", sf_st, out) * mk[None, :, :, None]
                out = torch.einsum("vbr,vrkK->vbkK", a_st, mid)
        if g == "RL" and f_l is not None:
            out = out * f_l[None, None, :]
        elif g == "RZ" and f_z is not None:
            out = out * f_z[None, None, :]
        elif g == "RLZ":
            if f_l is not None:
                out = out * f_l[None, None, :, None]
            if f_z is not None:
                out = out * f_z[None, None, None, :]
        return out

    return apply


def build(model, grid, ctx, dtype):
    opts = ctx.options
    tau = float(opts["modal_filter_tau"])
    if tau <= 0.0:  # the port builds no filter
        return lambda spec: spec
    return build_modal_filter(grid, tau, int(opts.get("modal_filter_order", 4)), model.ts,
                              dtype, axes=str(opts.get("modal_filter_axes", "rlz")))
