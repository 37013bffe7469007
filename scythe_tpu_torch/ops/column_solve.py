"""Fused AI2* vertical column solve: a hand-written CUDA kernel for Hopper
and its plain PyTorch version.

Replaces the Pallas TPU kernel ``scythe_tpu/ops/pallas_semiimplicit.py``
(``fused_column_solve``).  For a batch of vertical columns ``[ncols, nz]``:

    xf = F  x*            (Chebyshev truncation refit of xi*)
    g  = ts' Pxi (Dz x*) - w*,  then g -> [0, 0, g[1:nz-1]]  (BC rows)
    a  = Hinv g           (prefactorized Helmholtz solve)
    w  = S a ;  xi = xf - ts' (Ds a)

``Dz`` is applied to the raw x*, as the TPU kernel does; the einsum path of
``scythe_tpu.timeintegration`` applies it to the refit x*, which composes to
the same operator up to rounding.

The kernel (``csrc/column_solve.cu``) keeps each tile of columns and every
intermediate in shared memory; its header says what bounds it.  The
wrapper ``fused_column_solve`` checks its inputs, then takes the plain
version for tensors on the CPU and launches the kernel for tensors on a CUDA
device; there is no fallback between the two.  ``launches`` counts kernel
launches only.  The bf16x3 ("comp") mode of the TPU kernel is not ported.
"""

from __future__ import annotations

import torch

# largest nz the kernel takes: its shared memory at kMaxNz in float64 is
# 192 KB of the 227 KB a Hopper block may use (column_solve.cu)
MAX_NZ = 128

launches = 0


def _check(xstar, wstar, ops) -> tuple[int, int]:
    if xstar.ndim != 2 or wstar.shape != xstar.shape:
        raise ValueError(
            f"x* and w* must both be [ncols, nz]; got {tuple(xstar.shape)} "
            f"and {tuple(wstar.shape)}"
        )
    ncols, nz = xstar.shape
    if ncols < 1:
        raise ValueError("fused_column_solve needs at least one column")
    if not 3 <= nz <= MAX_NZ:
        raise ValueError(
            f"fused_column_solve supports 3 <= nz <= {MAX_NZ}, got nz = {nz}"
        )
    if xstar.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {xstar.dtype}")
    for name, t in (("w*", wstar),) + tuple(zip(("F", "Dz", "Hinv", "S", "Ds"), ops)):
        if t.dtype != xstar.dtype or t.device != xstar.device:
            raise ValueError(
                f"{name} is {t.dtype} on {t.device}; x* is {xstar.dtype} on "
                f"{xstar.device}"
            )
    for name, t in zip(("F", "Dz", "Hinv", "S", "Ds"), ops):
        if tuple(t.shape) != (nz, nz):
            raise ValueError(f"{name} must be [{nz}, {nz}], got {tuple(t.shape)}")
    for t in (xstar, wstar) + tuple(ops):
        if not t.is_contiguous():
            raise ValueError("fused_column_solve needs contiguous tensors")
    return ncols, nz


def fused_column_solve_plain(xstar, wstar, F, Dz, Hinv, S, Ds, ts_term, pxi_bar):
    """The chain in plain PyTorch ([ncols, nz] @ operator^T per stage)."""
    xf = xstar @ F.T
    g = (ts_term * pxi_bar) * (xstar @ Dz.T) - wstar
    g = torch.cat([g.new_zeros(g.shape[0], 2), g[:, 1:-1]], dim=1)
    a = g @ Hinv.T
    return a @ S.T, xf - ts_term * (a @ Ds.T)


def _launch(xstar, wstar, ops, ncols, nz, ts_term, pxi_bar):
    global launches
    from ._build import load

    lib = load().lib
    fn = (
        lib.scythe_column_solve_f32
        if xstar.dtype == torch.float32
        else lib.scythe_column_solve_f64
    )
    w_out = torch.empty_like(xstar)
    xi_out = torch.empty_like(xstar)
    with torch.cuda.device(xstar.device):
        stream = torch.cuda.current_stream(xstar.device).cuda_stream
        err = fn(
            xstar.data_ptr(), wstar.data_ptr(), *(o.data_ptr() for o in ops),
            w_out.data_ptr(), xi_out.data_ptr(), ncols, nz,
            float(ts_term), float(pxi_bar), stream,
        )
    if err != 0:
        msg = lib.scythe_cuda_error_string(err).decode()
        raise RuntimeError(f"column_solve kernel launch failed: {msg} ({err})")
    launches += 1
    return w_out, xi_out


def fused_column_solve(xstar, wstar, F, Dz, Hinv, S, Ds, ts_term, pxi_bar):
    """Apply the fused chain to [ncols, nz] column batches; returns
    (w_new, xi_new).  Argument order as the TPU kernel's: x* (xi*) first.
    ``Hinv`` is the inverse of the BC-row-shuffled Helmholtz matrix
    (timeintegration.helmholtz_matrix); ``ts_term`` and ``pxi_bar`` are
    scalars."""
    ops = (F, Dz, Hinv, S, Ds)
    ncols, nz = _check(xstar, wstar, ops)
    if xstar.device.type == "cpu":
        return fused_column_solve_plain(xstar, wstar, *ops, ts_term, pxi_bar)
    if xstar.device.type != "cuda":
        raise ValueError(
            f"fused_column_solve runs on cpu or cuda tensors, got {xstar.device}"
        )
    return _launch(xstar, wstar, ops, ncols, nz, ts_term, pxi_bar)
