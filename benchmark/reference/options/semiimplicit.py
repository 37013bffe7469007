"""``options["semiimplicit"]``: the AI2* corrector of
``scythe_tpu_torch/timeintegration.py`` on (w, xi), composed into one column
operator a stage and applied as one matmul, with a scalar Pxi: the reference
state's column mean times ``si_scale`` (1.0 by default); the implicit
histories keep the [w, xi] rows alone.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import chebyshev

STAGE = "implicit"
ORDER = 0
IMP_ROWS = 2
PARAMS = ("si_scale",)


def helmholtz_matrix(nz: int, length: float, pxi: float, ts_term: float) -> np.ndarray:
    s = chebyshev.dct_matrix(nz)
    d2 = chebyshev.dct_2nd_derivative(nz, length)
    fac = ts_term * ts_term * np.atleast_1d(np.asarray(pxi, np.float64))
    h = fac[:, None] * d2 - s
    return np.vstack([fac[0] * s[0, :], fac[-1] * s[nz - 1, :], h[1:nz - 1, :]])


def compose_column_operator(F, Dz, Hinv, S, Ds, ts_term, pxi_bar) -> torch.Tensor:
    """The AI2* chain as one [2nz, 2nz] matrix M, ``[w | xi] = [x* | w*] M^T``."""
    nz = F.shape[0]
    j = torch.arange(2, nz)
    P = torch.zeros_like(F)
    P[j, j - 1] = 1.0
    hp = Hinv @ P
    pxi = torch.as_tensor(pxi_bar, dtype=F.dtype).reshape(-1, 1)
    hd = ts_term * (hp @ (pxi * Dz))
    w_rows = torch.cat([S @ hd, -(S @ hp)], dim=1)
    xi_rows = torch.cat([F - ts_term * (Ds @ hd), ts_term * (Ds @ hp)], dim=1)
    return torch.cat([w_rows, xi_rows], dim=0)


def semiimplicit_operators(nz, zmin, zmax, bdim, pxi_bar, ts, dtype, device):
    """(M at step 1, M after): each stage composed in float64, then cast."""
    length = zmax - zmin
    zops = chebyshev.build_ops(nz, zmin, zmax, bdim)
    r0a = zops.constrain @ zops.analysis
    f64 = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        zops.synth @ r0a, zops.dsynth @ r0a, zops.synth, zops.dsynth)]
    F, Dz, S, Ds = f64

    def stage(ts_term):
        hinv = torch.from_numpy(np.linalg.inv(helmholtz_matrix(nz, length, pxi_bar, ts_term)))
        m = compose_column_operator(F, Dz, hinv, S, Ds, ts_term, pxi_bar)
        return m.to(dtype=dtype, device=device)

    return stage(0.5 * ts), stage(1.25 * ts)


def semiimplicit_adjustment(ops, ts, w_np1, xi_np1, xidot_n, xidot_nm1, xidot_nm2,
                            wdot_n, wdot_nm1, wdot_nm2, t):
    m_t1, m = ops
    if t == 1:
        w_star = w_np1 - ts * xidot_n + 0.5 * ts * xidot_n
        xi_star = xi_np1 - ts * wdot_n + 0.5 * ts * wdot_n
        op = m_t1
    elif t == 2:
        w_star = (w_np1 - (0.5 * ts) * (3.0 * xidot_n - xidot_nm1) - ts * xidot_n
                  + 0.75 * ts * xidot_nm1)
        xi_star = (xi_np1 - (0.5 * ts) * (3.0 * wdot_n - wdot_nm1) - ts * wdot_n
                   + 0.75 * ts * wdot_nm1)
        op = m
    else:
        w_star = (w_np1 - (ts / 12.0) * (23.0 * xidot_n - 16.0 * xidot_nm1 + 5.0 * xidot_nm2)
                  - ts * xidot_n + 0.75 * ts * xidot_nm1)
        xi_star = (xi_np1 - (ts / 12.0) * (23.0 * wdot_n - 16.0 * wdot_nm1 + 5.0 * wdot_nm2)
                   - ts * wdot_n + 0.75 * ts * wdot_nm1)
        op = m
    shape = xi_star.shape
    nz = shape[-1]
    out = torch.cat([xi_star.reshape(-1, nz), w_star.reshape(-1, nz)], dim=1) @ op.T
    return out[:, :nz].reshape(shape), out[:, nz:].reshape(shape)


def build(model, grid, ctx, dtype):
    p = grid.params
    ts = model.ts
    si_scale = float(ctx.options.get("si_scale", 1.0))
    ops = semiimplicit_operators(p.zDim, p.zmin, p.zmax, p.b_zDim,
                                 si_scale * float(ctx.ref_state.Pxi_bar), ts, dtype,
                                 grid.device)
    w_i, xi_i = p.var_index("w"), p.var_index("xi")

    def implicit(var_np1, res, state):
        impdot = res.impdot
        w_new, xi_new = semiimplicit_adjustment(
            ops, ts, var_np1[w_i], var_np1[xi_i],
            impdot[w_i], state.impdot_nm1[0], state.impdot_nm2[0],
            impdot[xi_i], state.impdot_nm1[1], state.impdot_nm2[1], state.t)
        var_np1[w_i] = w_new
        var_np1[xi_i] = xi_new
        return var_np1, torch.stack([impdot[w_i], impdot[xi_i]]), state.impdot_nm1

    return implicit
