"""Time integration: IMEX AB3/AI2* explicit stepper + semi-implicit solve,
in PyTorch.

The counterpart of ``scythe_tpu.timeintegration`` (Durran & Blossey 2012
AI2*-AB3; ref src/semiimplicit.jl:521-597 and :672-726).  The step index
``t`` stays a Python int on the host, so the startup ramp (forward Euler at
t = 1, AB2 at t = 2, AB3 after) is a Python branch, where the JAX package
switches on a traced index.  The AI2* corrector's column chain is
composed into one operator per stage, once, with the other operators, and
runs through ``ops.column_solve.apply_column_operator``: on the card the
CUDA kernel, on the CPU its plain version (one matmul by the same operator).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .basis import chebyshev
from .ops import column_solve


class ModelState(NamedTuple):
    """Prognostic state + multistep tendency history.

    ``spec``: spectral coefficients [nvars, ...]; histories are physical-space
    tensors.  ``expdot_*`` are [nvars, *spatial]; ``impdot_*`` are either
    full width or the slim [[w, xi], *spatial] layout (``imp_rows=2``), the
    only rows the AI2* corrector reads.  ``t`` is the 1-based index of the
    next step, a Python int.  A step never writes into a tensor it received
    here: the histories are handed on, not updated in place.
    """

    spec: torch.Tensor
    expdot_nm1: torch.Tensor
    expdot_nm2: torch.Tensor
    impdot_nm1: torch.Tensor
    impdot_nm2: torch.Tensor
    t: int


def initial_state(
    spec: torch.Tensor, phys_shape, dtype, imp_rows: int | None = None
) -> ModelState:
    """``imp_rows=2`` selects the slim [w, xi] implicit-history layout
    (semi-implicit configurations only — model.imp_history_rows picks)."""
    z = torch.zeros(tuple(phys_shape), dtype=dtype, device=spec.device)
    if imp_rows is None or imp_rows == phys_shape[0]:
        zi = z
    else:
        zi = torch.zeros(
            (imp_rows,) + tuple(phys_shape[1:]), dtype=dtype, device=spec.device
        )
    return ModelState(spec, z, z, zi, zi, 1)


def explicit_step(phys, expdot_n, expdot_nm1, expdot_nm2, t: int, ts: float):
    """AB3 update with startup ramp (ref explicit_timestep).  Returns a new
    tensor var_np1 plus the shifted explicit history."""
    if t == 1:
        var_np1 = phys + ts * expdot_n
    elif t == 2:
        var_np1 = phys + (0.5 * ts) * (3.0 * expdot_n - expdot_nm1)
    else:
        var_np1 = phys + (ts / 12.0) * (
            23.0 * expdot_n - 16.0 * expdot_nm1 + 5.0 * expdot_nm2
        )
    return var_np1, expdot_n, expdot_nm1


def explicit_increment(var_np1, expdot_incr, t: int, ts: float):
    """Post-hoc forcing increment with the current AB weights (ref
    explicit_increment, src/semiimplicit.jl:700-726)."""
    if t == 1:
        return var_np1 + ts * expdot_incr
    if t == 2:
        return var_np1 + (0.5 * ts) * (3.0 * expdot_incr)
    return var_np1 + (ts / 12.0) * (23.0 * expdot_incr)


# ----------------------------------------------------------------------
# Semi-implicit vertical Helmholtz machinery


def helmholtz_matrix(nz: int, length: float, pxi, ts_term: float) -> np.ndarray:
    """The reference's Helmholtz system matrix (ref
    calc_Helmholtz_semiimplicit_matrix, src/semiimplicit.jl:768-781): rows
    [bc_bottom; bc_top; interior rows 2..nz-1] of (ts_term^2 Pxi) d2 - S.
    ``pxi`` is a scalar or an [nz] profile, as in the JAX package."""
    s = chebyshev.dct_matrix(nz)
    d2 = chebyshev.dct_2nd_derivative(nz, length)
    fac = ts_term * ts_term * np.atleast_1d(np.asarray(pxi, np.float64))
    h = fac[:, None] * d2 - s
    bc1 = fac[0] * s[0, :]
    bc2 = fac[-1] * s[nz - 1, :]
    return np.vstack([bc1, bc2, h[1 : nz - 1, :]])


class SemiImplicitOps(NamedTuple):
    """Precomputed operators for the batched semi-implicit adjustment."""

    hinv_t1: torch.Tensor  # [nz, nz] inverse for ts_term = ts/2 (step 1)
    hinv: torch.Tensor  # [nz, nz] inverse for ts_term = 1.25 ts
    col_filter: torch.Tensor  # [nz, nz] truncation refit
    col_deriv: torch.Tensor  # [nz, nz] d/dz of the truncated refit
    synth: torch.Tensor  # [nz, nz] coeff -> value
    dsynth: torch.Tensor  # [nz, nz] coeff -> d/dz
    pxi_bar: Any  # scalar Pxi (a host float), or an [nz] float64 profile
    ts: float
    # the column chain composed into one operator (column_solve.ColumnOperator)
    # for step 1 (ts_term = ts/2, hinv_t1) and for AB3 (1.25 ts, hinv)
    solve_t1: column_solve.ColumnOperator
    solve: column_solve.ColumnOperator


def build_semiimplicit_ops(
    nz, zmin, zmax, bdim, pxi_bar, ts, dtype, device: Any, use_pallas: bool | None = None
) -> SemiImplicitOps:
    """Operators built in float64, composed per stage in float64, then cast
    to ``dtype`` on ``device`` (the grid's: no default).  ``pxi_bar`` is the
    reference column's scalar Pxi, or an [nz] per-level profile
    (options['si_mode']='variable'): the Helmholtz rows and the Pxi Dz term
    then take the local coefficient.  Either way each stage is one composed
    operator, so the kernel computes both modes; the JAX package refuses a
    profile on its Pallas path and takes its einsum chain for it, where the
    port takes its kernel by design.

    ``use_pallas`` mirrors the JAX package's: True builds each stage as a
    comp operator (``column_solve.column_operator(..., mode="comp")``), so
    ``semiimplicit_adjustment`` applies the bf16x3 product of the TPU
    function's default mode (the comp kernel on the card, its plain version
    on the CPU; float32 only); as in JAX it refuses a Pxi profile.  None
    (the default) means False: the plain operator."""
    if use_pallas and np.ndim(pxi_bar) > 0:
        raise ValueError(
            "the fused column solve's comp mode (use_pallas=True) supports only "
            "the constant-coefficient mode (scalar pxi), as the JAX package's "
            "Pallas path; si_mode='variable' uses the plain operator"
        )
    mode = "comp" if use_pallas else "plain"
    if np.ndim(pxi_bar) > 0:
        pxi_bar = np.asarray(pxi_bar, np.float64)
        if pxi_bar.shape != (nz,):
            raise ValueError(f"a Pxi profile must be [{nz}], got {list(pxi_bar.shape)}")
    else:
        pxi_bar = float(pxi_bar)
    length = zmax - zmin
    h1 = helmholtz_matrix(nz, length, pxi_bar, 0.5 * ts)
    h = helmholtz_matrix(nz, length, pxi_bar, 1.25 * ts)
    zops = chebyshev.build_ops(nz, zmin, zmax, bdim)
    r0a = zops.constrain @ zops.analysis
    f64 = {
        "hinv_t1": np.linalg.inv(h1),
        "hinv": np.linalg.inv(h),
        "col_filter": zops.synth @ r0a,
        "col_deriv": zops.dsynth @ r0a,
        "synth": zops.synth,
        "dsynth": zops.dsynth,
    }
    f64 = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in f64.items()}

    def stage(ts_term, hinv):
        m = column_solve.compose_column_operator(
            f64["col_filter"], f64["col_deriv"], hinv, f64["synth"], f64["dsynth"],
            ts_term, pxi_bar,
        )
        return column_solve.column_operator(m, dtype, device, mode)

    return SemiImplicitOps(
        **{k: v.to(dtype=dtype, device=device) for k, v in f64.items()},
        pxi_bar=pxi_bar,
        ts=ts,
        solve_t1=stage(0.5 * ts, f64["hinv_t1"]),
        solve=stage(1.25 * ts, f64["hinv"]),
    )


def semiimplicit_adjustment(
    ops: SemiImplicitOps,
    w_np1,
    xi_np1,
    xidot_n,
    xidot_nm1,
    xidot_nm2,
    wdot_n,
    wdot_nm1,
    wdot_nm2,
    t: int,
):
    """Batched AI2* corrector for (w, xi) (ref semiimplicit_adjustment,
    src/semiimplicit.jl:521-597).  All inputs are [..., nz] with z last;
    ``xidot_*`` is the implicit tendency of w (= -Pxi xi_z) and ``wdot_*``
    that of xi (= -w_z), matching the reference's view naming.  The column
    chain is the stage's composed operator, applied by
    ``column_solve.apply_column_operator`` to the [-1, nz] view of its
    (xi*, w*).  Returns (w_new, xi_new)."""
    ts = ops.ts
    if t == 1:
        # trapezoidal (AM2): subtract Euler-explicit, add ts/2-implicit
        w_star = w_np1 - ts * xidot_n + 0.5 * ts * xidot_n
        xi_star = xi_np1 - ts * wdot_n + 0.5 * ts * wdot_n
        solve = ops.solve_t1
    elif t == 2:
        w_star = (
            w_np1
            - (0.5 * ts) * (3.0 * xidot_n - xidot_nm1)
            - ts * xidot_n
            + 0.75 * ts * xidot_nm1
        )
        xi_star = (
            xi_np1
            - (0.5 * ts) * (3.0 * wdot_n - wdot_nm1)
            - ts * wdot_n
            + 0.75 * ts * wdot_nm1
        )
        solve = ops.solve
    else:
        w_star = (
            w_np1
            - (ts / 12.0) * (23.0 * xidot_n - 16.0 * xidot_nm1 + 5.0 * xidot_nm2)
            - ts * xidot_n
            + 0.75 * ts * xidot_nm1
        )
        xi_star = (
            xi_np1
            - (ts / 12.0) * (23.0 * wdot_n - 16.0 * wdot_nm1 + 5.0 * wdot_nm2)
            - ts * wdot_n
            + 0.75 * ts * wdot_nm1
        )
        solve = ops.solve

    shape = xi_star.shape
    nz = shape[-1]
    w_new, xi_new = column_solve.apply_column_operator(
        xi_star.reshape(-1, nz).contiguous(),
        w_star.reshape(-1, nz).contiguous(),
        solve,
    )
    return w_new.reshape(shape), xi_new.reshape(shape)
