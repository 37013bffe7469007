"""Discretely-balanced initialization, in PyTorch.

The counterpart of ``scythe_tpu.balance``: find the zonal-mean
thermodynamic corrections (s, xi) that zero the model's own instantaneous
(v, w) tendencies, the discrete gradient-wind + hydrostatic balance, by
Newton iteration with the exact Jacobian in forward mode.

The Jacobian is dense, built ``jac_chunk`` columns at a time by
``torch.func.jvp`` under ``torch.func.vmap``; the residual goes through
``Grid.analysis``, so on the card every column block runs the analysis
kernel's jvp and vmap rules (one launch for the whole block).  The
least-squares step is a truncated SVD (relative ``rcond`` 1e-6), the
arithmetic of ``jnp.linalg.lstsq``.

The solve runs on a small-nl replica grid (``nl_solve``): a zonally
uniform state has only k = 0 content, so the zonal-mean operators and the
correction are those of the production grid.

Device: the port's rule, the card unless the caller asks for the CPU, in
float64.  The JAX package solves on its CPU backend by default
(``on_cpu=True``); here ``on_cpu=True`` means ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .device import DEFAULT
from .equations.common import get_equation_set
from .grids.base import create_grid


def _total_tendency(eqset, grid, ctx, phys):
    """The model's instantaneous tendency of the fitted state, re-fitted
    through the spectral basis: ``expdot`` alone (its rows carry the full
    tendency; ``impdot`` repeats the acoustic piece the AI2* corrector
    re-adds), and analysis -> synthesis of it, since the model only ever
    integrates the fitted tendency (scythe_tpu.balance._total_tendency)."""
    fields = grid.synthesis(grid.analysis(phys))
    res = eqset(fields, ctx)
    return grid.synthesis(grid.analysis(res.expdot))["val"]


def _lstsq(J, b, rcond):
    """min |J x - b| by the SVD, singular values below ``rcond`` times the
    largest taken as zero (jnp.linalg.lstsq's arithmetic)."""
    u, s, vh = torch.linalg.svd(J, full_matrices=False)
    mask = s >= rcond * s[0]
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, torch.ones_like(s)), 0.0)
    return vh.T @ (s_inv * (u.T @ b))


def balance_zonal_state(
    model,
    zonal_mean,
    dtype=torch.float64,
    correct=("s", "xi"),
    residual=("v", "w"),
    nl_solve=4,
    iters=3,
    jac_chunk=128,
    verbose=False,
    on_cpu=False,
    device: Any = DEFAULT,
):
    """Solve the model's discrete balance for a zonally symmetric state.

    ``zonal_mean``: [nvars, rDim, zDim] zonal-mean physical fields; rows of
    ``correct`` are adjusted, the rest (the target wind) held.  Returns
    ``(balanced [nvars, rDim, zDim] float64 numpy, info)``; info['history']
    holds the residual max-norm of every Newton iterate, [0] the given
    state's own.  ``on_cpu=True`` asks for the CPU, as ``device="cpu"``."""
    if on_cpu:
        device = "cpu"
    gp = model.grid_params
    grid = create_grid(dataclasses.replace(gp, lDim=int(nl_solve)), dtype, device=device)
    from .model import build_context

    ctx = build_context(model, grid, dtype)
    eqset = get_equation_set(model.equation_set)
    vi = grid.params.var_index
    ic = [vi(n) for n in correct]
    ir = [vi(n) for n in residual]
    rDim, nl, zDim = grid.params.rDim, grid.nl, grid.params.zDim
    dev = grid.device
    zm = torch.as_tensor(np.asarray(zonal_mean), dtype=dtype, device=dev)
    base = zm[:, :, None, :].expand(-1, -1, nl, -1)
    # unknowns scaled to O(1): s (J/kg/K) by 10, xi (log density) by 0.03
    scales = torch.tensor([10.0 if n == "s" else 0.03 for n in correct], dtype=dtype,
                          device=dev)[:, None, None]

    def raw_residual(x):
        rows = list(base.unbind(0))
        for j, i in enumerate(ic):
            rows[i] = rows[i] + (x[j] * scales[j])[:, None, :]
        tot = _total_tendency(eqset, grid, ctx, torch.stack(rows))
        # the state is zonally uniform: the zonal mean of the residual rows
        return torch.stack([tot[i].mean(dim=1) for i in ir])

    # row weights bounded to 100:1 (scythe_tpu.balance: an unbounded weight
    # on a row that starts balanced drowns every other row's physics)
    x = torch.zeros((len(ic), rDim, zDim), dtype=dtype, device=dev)
    r0 = raw_residual(x)
    r0max = float(r0.abs().max())
    row_w = torch.tensor(
        [1.0 / max(float(r0[j].abs().max()), 1e-2 * r0max, 1e-30) for j in range(len(ir))],
        dtype=dtype, device=dev,
    )[:, None, None]

    def residual_fn(x):
        return raw_residual(x) * row_w

    n = len(ic) * rDim * zDim

    def jac(x):
        """The dense weighted Jacobian [n_res, n], jac_chunk forward-mode
        columns at a time."""

        def jvp_one(tangent):
            return torch.func.jvp(residual_fn, (x,), (tangent.reshape(x.shape),))[1].reshape(-1)

        eye = torch.eye(n, dtype=dtype, device=dev)
        cols = [torch.func.vmap(jvp_one)(eye[s0:s0 + jac_chunk]) for s0 in range(0, n, jac_chunk)]
        return torch.cat(cols, dim=0).T

    def maxnorm(x):
        return float(raw_residual(x).abs().max())

    history = [r0max]
    for it in range(int(iters)):
        r = residual_fn(x)
        # truncated SVD: the grid-point unknowns are ~3x redundant against
        # the fit space, so J has an exact nullspace far below rcond
        dx = _lstsq(jac(x), -r.reshape(-1), 1e-6).reshape(x.shape)
        # backtracking on the weighted norm
        best, best_x = None, None
        for step in (1.0, 0.5, 0.25, 0.1):
            cand = x + step * dx
            nrm = float(torch.linalg.norm(residual_fn(cand)))
            if best is None or nrm < best:
                best, best_x = nrm, cand
        if best >= float(torch.linalg.norm(r)):
            break  # no descent direction left
        x = best_x
        history.append(maxnorm(x))
        if verbose:
            print(f"balance iter {it + 1}: max|r| {history[-1]:.3e}")
        if history[-1] < 1e-14:
            break

    out = np.asarray(zonal_mean, np.float64).copy()
    corr = (x * scales).cpu().numpy().astype(np.float64)
    for j, i in enumerate(ic):
        out[i] = out[i] + corr[j]
    return out, {"history": history, "n_unknowns": n}
