"""The AI2* column solve of the port (ops.column_solve) against the JAX
package: its plain version against the einsum path of
scythe_tpu.timeintegration.semiimplicit_adjustment (1e-10 of max|ref|, f64),
and against the Pallas kernel in interpret mode (mode="plain", f32, atol
2e-4 of max|ref| as in tests/test_pallas_semiimplicit.py).  The CUDA kernel
itself runs only on the card: chip_smoke.py holds it against this plain
version there."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scythe_tpu import timeintegration as jti
from scythe_tpu.ops.pallas_semiimplicit import fused_column_solve as pallas_solve
from scythe_tpu_torch import timeintegration as tti
from scythe_tpu_torch.ops import column_solve

torch.set_num_threads(2)


def _ops(nz, ts, pxi, zmax=10000.0):
    j = jti.build_semiimplicit_ops(nz, 0.0, zmax, None, pxi, ts, jnp.float64)
    t = tti.build_semiimplicit_ops(nz, 0.0, zmax, None, pxi, ts, torch.float64)
    return j, t


def _rel_err(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("nz,ncols", [(24, 37), (40, 96), (48, 37)])
@pytest.mark.parametrize("t", [1, 2, 5])
def test_adjustment_matches_einsum_path(nz, ncols, t):
    ts, pxi = 0.2, 9.0e4
    oj, ot = _ops(nz, ts, pxi)
    rng = np.random.default_rng(nz + t)
    # w_np1, xi_np1, xidot_{n,nm1,nm2}, wdot_{n,nm1,nm2}, each [ncols, nz]
    args = [rng.normal(size=(ncols, nz)) for _ in range(8)]
    wj, xj = jti.semiimplicit_adjustment(
        oj, *(jnp.asarray(a) for a in args), jnp.asarray(t)
    )
    wt, xt = tti.semiimplicit_adjustment(
        ot, *(torch.from_numpy(a) for a in args), t
    )
    assert _rel_err(wt, wj) <= 1e-10
    assert _rel_err(xt, xj) <= 1e-10


def test_adjustment_keeps_leading_axes():
    oj, ot = _ops(16, 0.25, 8.0e4)
    rng = np.random.default_rng(3)
    args = [rng.normal(size=(5, 4, 16)) for _ in range(8)]
    wj, xj = jti.semiimplicit_adjustment(oj, *map(jnp.asarray, args), jnp.asarray(3))
    wt, xt = tti.semiimplicit_adjustment(ot, *map(torch.from_numpy, args), 3)
    assert wt.shape == (5, 4, 16)
    assert _rel_err(wt, wj) <= 1e-10 and _rel_err(xt, xj) <= 1e-10


@pytest.mark.parametrize("nz,ncols,tile", [(24, 37, 16), (40, 96, 32), (40, 37, 16)])
@pytest.mark.parametrize("stage", ["t1", "ab"])
def test_plain_matches_pallas_interpret(nz, ncols, tile, stage):
    ts, pxi = 0.2, 9.0e4
    oj, ot = _ops(nz, ts, pxi)
    ts_term, hj, ht = (
        (0.5 * ts, oj.hinv_t1, ot.hinv_t1) if stage == "t1"
        else (1.25 * ts, oj.hinv, ot.hinv)
    )
    rng = np.random.default_rng(ncols)
    x = rng.normal(size=(ncols, nz))
    w = rng.normal(size=(ncols, nz))
    wk, xk = pallas_solve(
        jnp.asarray(x), jnp.asarray(w), oj.col_filter, oj.col_deriv, hj,
        oj.synth, oj.dsynth, ts_term, pxi, interpret=True, tile=tile, mode="plain",
    )
    wp, xp = column_solve.fused_column_solve_plain(
        torch.from_numpy(x), torch.from_numpy(w), ot.col_filter, ot.col_deriv,
        ht, ot.synth, ot.dsynth, ts_term, pxi,
    )
    for got, ref in ((wp, wk), (xp, xk)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        np.testing.assert_allclose(
            got.numpy(), ref, atol=2e-4 * np.abs(ref).max(), rtol=1e-7
        )


def test_wrapper_on_cpu_takes_plain_and_counts_nothing():
    _, ot = _ops(24, 0.1, 1.0e5, zmax=1000.0)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(37, 24)))
    w = torch.from_numpy(rng.normal(size=(37, 24)))
    ops = (ot.col_filter, ot.col_deriv, ot.hinv, ot.synth, ot.dsynth)
    before = column_solve.launches
    got = column_solve.fused_column_solve(x, w, *ops, 0.125, 1.0e5)
    ref = column_solve.fused_column_solve_plain(x, w, *ops, 0.125, 1.0e5)
    assert column_solve.launches == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_plain_bc_shift_drops_first_and_last_g():
    """g -> [0, 0, g[1], ..., g[nz-2]]: with identity operators and
    ts' Pxi = 1, a = shift(x* - w*)."""
    nz = 6
    eye = torch.eye(nz, dtype=torch.float64)
    x = torch.arange(1.0, nz + 1, dtype=torch.float64)[None] * 10.0
    w = torch.arange(1.0, nz + 1, dtype=torch.float64)[None]
    w_new, xi_new = column_solve.fused_column_solve_plain(
        x, w, eye, eye, eye, eye, eye, 1.0, 1.0
    )
    g = (x - w)[0]
    assert w_new[0].tolist() == [0.0, 0.0] + g[1:nz - 1].tolist()
    assert torch.equal(xi_new, x - w_new)


@pytest.mark.parametrize(
    "shape,ops_nz,dtype,match",
    [
        ((8, column_solve.MAX_NZ + 1), column_solve.MAX_NZ + 1, torch.float64, "nz"),
        ((8, 2), 2, torch.float64, "nz"),
        ((8, 16), 12, torch.float64, r"\[16, 16\]"),
        ((8, 16), 16, torch.float16, "dtype"),
    ],
    ids=["nz-above-bound", "nz-below-bound", "operator-shape", "dtype"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(shape, ops_nz, dtype, match):
    x = torch.zeros(shape, dtype=dtype)
    op = torch.zeros((ops_nz, ops_nz), dtype=dtype)
    with pytest.raises(ValueError, match=match):
        column_solve.fused_column_solve(x, x.clone(), op, op, op, op, op, 0.1, 1.0)


def test_wrapper_rejects_mixed_dtypes_and_strided_input():
    x = torch.zeros((8, 16), dtype=torch.float64)
    op = torch.zeros((16, 16), dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        column_solve.fused_column_solve(x, x, op.float(), op, op, op, op, 0.1, 1.0)
    xt = torch.zeros((16, 8), dtype=torch.float64).T
    with pytest.raises(ValueError, match="contiguous"):
        column_solve.fused_column_solve(xt, xt, op, op, op, op, op, 0.1, 1.0)


def test_variable_si_mode_is_not_ported():
    with pytest.raises(NotImplementedError, match="si_mode"):
        tti.build_semiimplicit_ops(16, 0.0, 1.0e4, None, np.full(16, 9.0e4), 0.2,
                                   torch.float64)
