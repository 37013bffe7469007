"""``options["implicit_vdiff"]``: backward-Euler vertical diffusion of every
K-diffused variable by the equation set's vertical diffusivity
(``EqResult.k_v``), one batched LU a column (``scythe_tpu_torch/model.py``'s
``build_implicit_vdiff``), after the implicit stage.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import chebyshev

STAGE = "update"
ORDER = 10


@contextlib.contextmanager
def _linalg_library(name: str):
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library(name)
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def batched_solve(m, rhs):
    """LU with partial pivoting, batched (cuBLAS's getrf / getrs on a card)."""
    if m.device.type != "cuda":
        return torch.linalg.solve_ex(m, rhs)[0]
    with _linalg_library("cusolver"):
        return torch.linalg.solve_ex(m, rhs)[0]


def build_implicit_vdiff(grid, dtype, exclude=("xi", "qss")):
    """Backward-Euler vertical diffusion (I + ts W^-1 D^T diag(w_q K_v) D)
    phi^{n+1} = phi* per column, every K-diffused variable a right-hand side."""
    p = grid.params
    nz = p.zDim
    z0 = chebyshev.build_ops(nz, p.zmin, p.zmax, p.b_zDim)
    d_r0 = z0.dsynth @ (z0.constrain @ z0.analysis)
    theta = np.pi * (np.arange(nz) + 0.5) / nz
    wq = 0.5 * (p.zmax - p.zmin) * (np.pi / nz) * np.sin(theta)

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=grid.device)

    dmat, wq_t, winv = dev(d_r0), dev(wq), dev(1.0 / wq)
    idxs = tuple(v for v, name in enumerate(p.vars) if name not in exclude)
    eye = torch.eye(nz, dtype=dtype, device=grid.device)

    def apply(var_np1, k_v, ts):
        s = torch.einsum("mi,...m,mj->...ij", dmat, wq_t * k_v, dmat)
        m = eye + ts * (winv[:, None] * s)
        rhs = torch.stack([var_np1[i] for i in idxs], dim=-1)
        sol = batched_solve(m, rhs)
        for k, i in enumerate(idxs):
            var_np1[i] = sol[..., k]
        return var_np1

    return apply


def build(model, grid, ctx, dtype):
    apply = build_implicit_vdiff(grid, dtype)
    ts = model.ts

    def update(var_np1, res):
        return apply(var_np1, res.k_v, ts)

    return update
