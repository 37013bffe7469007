"""The AI2* column solve of the port (ops.column_solve) against the JAX
package: semiimplicit_adjustment, which applies each stage's composed
operator (on the CPU one matmul by it), against the einsum path of
scythe_tpu.timeintegration.semiimplicit_adjustment (1e-10 of max|ref|, f64);
the plain chain and the composed path against the Pallas kernel in
interpret mode (mode="plain", atol 2e-4 of max|ref| as in
tests/test_pallas_semiimplicit.py).  The CUDA kernel
itself runs only on the card: chip_smoke.py holds it against this plain
version there.

On the CPU the kernel's arithmetic is rehearsed instead: the composed
operator (compose_column_operator) against the chain, the plan's tiles, and
a block-by-block emulation of the kernel's decomposition (column tiles, N
parts, K slabs, the packed fragment order and the 3xTF32 split) against the
chain: f64 within 1e-13 of max|ref|, f32 at most 4x the f32 chain's own
error against the f64 chain (the rule chip_smoke.py applies on the card).

The comp mode (the TPU function's default, ``_kernel_comp``: bf16x3 products,
here of the composed M) against the Pallas kernel in interpret mode with
mode="comp" at tests/test_pallas_semiimplicit.py's comp bar (atol 1e-2 of
max|ref|, rtol 1e-4) and against the f64 chain, directly and through
semiimplicit_adjustment with use_pallas=True (the JAX option's counterpart);
its packing (M's bf16 split in the m16n8k16 fragment order, the JAX
package's _split bit for bit), its plan (plan_comp: fits, covers every
column once) and an emulation of its own body block by block against its
plain version, and its autograd rules."""

import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scythe_tpu import timeintegration as jti
from scythe_tpu.ops.pallas_semiimplicit import fused_column_solve as pallas_solve
from scythe_tpu_torch import timeintegration as tti
from scythe_tpu_torch.ops import column_solve
from scythe_tpu_torch.ops.bf16x3 import bf16_round

torch.set_num_threads(2)


def _ops(nz, ts, pxi, zmax=10000.0):
    j = jti.build_semiimplicit_ops(nz, 0.0, zmax, None, pxi, ts, jnp.float64)
    t = tti.build_semiimplicit_ops(nz, 0.0, zmax, None, pxi, ts, torch.float64, "cpu")
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
    got = column_solve.fused_column_solve(x, w, *ops, 0.125, 1.0e5, mode="plain")
    ref = column_solve.fused_column_solve_plain(x, w, *ops, 0.125, 1.0e5)
    assert column_solve.launches == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_apply_operator_on_cpu_takes_plain_and_counts_nothing():
    _, ot = _ops(24, 0.1, 1.0e5, zmax=1000.0)
    x, w = _columns(37, 24, 1)
    before = column_solve.launches
    got = column_solve.apply_column_operator(x, w, ot.solve)
    ref = torch.cat([x, w], dim=1) @ ot.solve.M.T
    assert column_solve.launches == before
    assert torch.equal(got[0], ref[:, :24]) and torch.equal(got[1], ref[:, 24:])
    assert got[0].is_contiguous() and got[1].is_contiguous()


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_column_operator_is_one_m(dtype):
    """M and the kernel's packed operator both come from the one float64 M."""
    m64 = torch.from_numpy(np.random.default_rng(2).normal(size=(26, 26)))
    op = column_solve.column_operator(m64, dtype, "cpu")
    assert torch.equal(op.M, m64.to(dtype))
    assert torch.equal(op.packed, column_solve.pack_operator(m64, dtype))


@pytest.mark.parametrize(
    "m_shape,m_dtype,match",
    [((24, 24), torch.float64, r"\[26, 26\]"), ((26, 26), torch.float32, "float32")],
    ids=["operator-shape", "operator-dtype"],
)
def test_apply_operator_rejects_an_operator_of_another_shape(m_shape, m_dtype, match):
    x = torch.zeros((8, 13), dtype=torch.float64)
    op = column_solve.ColumnOperator(M=torch.zeros(m_shape, dtype=m_dtype),
                                     packed=torch.zeros(0))
    with pytest.raises(ValueError, match=match):
        column_solve.apply_column_operator(x, x.clone(), op)


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


def _profile(nz):
    """A per-level Pxi falling with height, as a sounding's Pxi_prof does."""
    return 9.0e4 * np.exp(-np.linspace(0.0, 1.2, nz))


def test_variable_si_mode_is_not_ported():
    """si_mode='variable' builds: a per-level profile is one more composed
    operator, a constant profile composes the scalar's operator (1e-13), and a
    profile of the wrong length is refused."""
    flat = tti.build_semiimplicit_ops(16, 0.0, 1.0e4, None, np.full(16, 9.0e4), 0.2,
                                      torch.float64, "cpu")
    scalar = tti.build_semiimplicit_ops(16, 0.0, 1.0e4, None, 9.0e4, 0.2, torch.float64,
                                        "cpu")
    for a, b in ((flat.solve, scalar.solve), (flat.solve_t1, scalar.solve_t1)):
        assert float((a.M - b.M).abs().max()) <= 1e-13 * float(b.M.abs().max())
    prof = tti.build_semiimplicit_ops(16, 0.0, 1.0e4, None, _profile(16), 0.2,
                                      torch.float64, "cpu")
    assert float((prof.solve.M - scalar.solve.M).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="profile"):
        tti.build_semiimplicit_ops(16, 0.0, 1.0e4, None, np.full(15, 9.0e4), 0.2,
                                   torch.float64, "cpu")


@pytest.mark.parametrize("t", [1, 2, 5])
@pytest.mark.parametrize("nz", [16, 32, 48])
def test_adjustment_with_profile_matches_einsum_path(nz, t):
    """The variable-coefficient corrector through the composed operator
    against the JAX einsum path, which broadcasts the profile over the
    output z axis (1e-10 of max|ref|, as the scalar case)."""
    oj, ot = _ops(nz, 0.2, _profile(nz))
    rng = np.random.default_rng(nz + 7 * t)
    args = [rng.normal(size=(29, nz)) for _ in range(8)]
    wj, xj = jti.semiimplicit_adjustment(oj, *(jnp.asarray(a) for a in args), jnp.asarray(t))
    wt, xt = tti.semiimplicit_adjustment(ot, *(torch.from_numpy(a) for a in args), t)
    assert _rel_err(wt, wj) <= 1e-10 and _rel_err(xt, xj) <= 1e-10


@pytest.mark.parametrize("stage", ["t1", "ab"])
@pytest.mark.parametrize("nz", (13, 24, 32, 48))
def test_composed_operator_with_profile_matches_chain_f64(nz, stage):
    ot = tti.build_semiimplicit_ops(nz, 0.0, 10000.0, None, _profile(nz), 0.15,
                                    torch.float64, "cpu")
    ops, ts_term = _stage_ops(ot, stage)
    x, w = _columns(64, nz, nz + 1)
    ref = column_solve.fused_column_solve_plain(x, w, *ops, ts_term, ot.pxi_bar)
    m = column_solve.compose_column_operator(*ops, ts_term, ot.pxi_bar)
    assert torch.equal(m, (ot.solve_t1 if stage == "t1" else ot.solve).M)
    out = torch.cat([x, w], dim=1) @ m.T
    assert _max_rel((out[:, :nz], out[:, nz:]), ref) <= 1e-13
    # the TPU function's counterpart takes the profile too (plain on the CPU)
    got = column_solve.fused_column_solve(x, w, *ops, ts_term, torch.from_numpy(ot.pxi_bar),
                                          mode="plain")
    assert _max_rel(got, ref) <= 1e-15


# ---- the composed operator, the kernel's plan and its decomposition


def _stage_ops(ot, stage):
    """(F, Dz, Hinv, S, Ds, ts_term) of a stage of ``ot`` (ts = ot.ts)."""
    ts_term, hinv = (0.5 * ot.ts, ot.hinv_t1) if stage == "t1" else (1.25 * ot.ts, ot.hinv)
    return (ot.col_filter, ot.col_deriv, hinv, ot.synth, ot.dsynth), ts_term


def _columns(ncols, nz, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(ncols, nz))),
            torch.from_numpy(rng.normal(size=(ncols, nz))))


def _max_rel(got, ref):
    return max(float((g.double() - r).abs().max() / r.abs().max())
               for g, r in zip(got, ref))


COMPOSE_NZ = (3, 13, 24, 48, 100, 128)


@pytest.mark.parametrize("stage", ["t1", "ab"])
@pytest.mark.parametrize("nz", COMPOSE_NZ)
def test_composed_operator_matches_chain_f64(nz, stage):
    ot = tti.build_semiimplicit_ops(nz, 0.0, 10000.0, None, 9.0e4, 0.15,
                                    torch.float64, "cpu")
    ops, ts_term = _stage_ops(ot, stage)
    x, w = _columns(64, nz, nz)
    ref = column_solve.fused_column_solve_plain(x, w, *ops, ts_term, ot.pxi_bar)
    m = column_solve.compose_column_operator(*ops, ts_term, ot.pxi_bar)
    assert torch.equal(m, (ot.solve_t1 if stage == "t1" else ot.solve).M)
    out = torch.cat([x, w], dim=1) @ m.T
    assert _max_rel((out[:, :nz], out[:, nz:]), ref) <= 1e-13


@pytest.mark.parametrize("stage", ["t1", "ab"])
@pytest.mark.parametrize("nz", COMPOSE_NZ)
def test_composed_operator_f32_error_within_4x_the_chain(nz, stage):
    o64 = tti.build_semiimplicit_ops(nz, 0.0, 10000.0, None, 9.0e4, 0.15,
                                     torch.float64, "cpu")
    o32 = tti.build_semiimplicit_ops(nz, 0.0, 10000.0, None, 9.0e4, 0.15,
                                     torch.float32, "cpu")
    ops64, ts_term = _stage_ops(o64, stage)
    ops32, _ = _stage_ops(o32, stage)
    x, w = _columns(512, nz, 100 + nz)
    ref = column_solve.fused_column_solve_plain(x, w, *ops64, ts_term, o64.pxi_bar)
    chain32 = column_solve.fused_column_solve_plain(
        x.float(), w.float(), *ops32, ts_term, o32.pxi_bar)
    m32 = (o32.solve_t1 if stage == "t1" else o32.solve).M
    out = torch.cat([x, w], dim=1).float() @ m32.T
    composed = _max_rel((out[:, :nz], out[:, nz:]), ref)
    assert composed <= 4.0 * _max_rel(chain32, ref) and composed <= 1e-5


def _ceil(a, b):
    return -(-a // b)


PLAN_NCOLS = (1, 16, 37, 100, 1200, 2111, 9216, 40000)
PLAN_NZ = (3, 8, 13, 24, 40, 48, 64, 72, 100, 110, 128, 81)


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("nz", PLAN_NZ)
def test_plan_fits_the_card_and_covers_every_column(nz, dtype):
    es = torch.empty((), dtype=dtype).element_size()
    K = 2 * _ceil(nz, 8) * 8
    bar = column_solve.BARRIER_BYTES
    for ncols in PLAN_NCOLS:
        p = column_solve.plan(ncols, nz, dtype)
        where = (ncols, nz, dtype, p)
        m_bytes, rings = column_solve.smem_layout(nz, es, p.rg, p.kslab, p.st)
        assert p.smem == bar + m_bytes + rings <= column_solve.SMEM_MAX, where
        full, _ = column_solve.smem_layout(nz, es, p.rg, K, p.st)
        # M resident exactly where it fits beside the rings; streamed only
        # with one row group, in slabs of an even number of K steps
        assert p.resident(nz) == (bar + full + rings <= column_solve.SMEM_MAX), where
        assert p.resident(nz) or p.rg == 1, where
        assert p.kslab % 16 == 0 and 16 <= p.kslab <= K, where
        assert 1 <= p.rg <= 4 and 2 <= p.st <= column_solve.MAX_ST, where
        # row groups of N / 16 warps, at most 576 threads
        assert p.threads == p.rg * 32 * (K // 16) <= 576, where
        # all blocks resident at once (shared memory, 112 registers a thread)
        per_sm = _ceil(p.blocks, column_solve.NUM_SMS)
        assert per_sm * (p.smem + 1024) <= column_solve.SMEM_SM, where
        assert per_sm * p.threads * 112 <= 65536, where
        # row group r of block b takes tiles b + blocks r, then every
        # (blocks rg)-th: every column tile once
        ntiles = _ceil(ncols, 16)
        assert 1 <= p.blocks <= _ceil(ntiles, p.rg), where
        taken = sorted(t for b in range(p.blocks) for r in range(p.rg)
                       for t in range(b + p.blocks * r, ntiles, p.blocks * p.rg))
        assert taken == list(range(ntiles)), where


def test_plan_meets_its_goals_at_the_main_path_shapes():
    f32 = torch.float32
    moist3d = column_solve.plan(9216, 48, f32)
    tc = column_solve.plan(1200, 24, f32)
    # moist3d: one block an SM, M resident once in it for three row groups
    # of warps, each keeping all of its tiles in flight
    assert moist3d.resident(48) and moist3d.rg == 3
    assert moist3d.blocks == column_solve.NUM_SMS
    assert moist3d.st == min(4, _ceil(576, 3 * moist3d.blocks))
    # the TC shape: one tile a block
    assert tc.rg == 1 and tc.blocks == _ceil(1200, 16)
    # large nz streams M in K slabs at f64
    assert not column_solve.plan(9216, 128, torch.float64).resident(128)


_tf32 = column_solve.tf32_round


def _emulate(x, w, packed, p):
    """The kernel's decomposition, block by block in its order: for each
    persistent block and row group, its column tiles; for each tile the K
    slabs
    and 8-deep K steps, with B read from the packed fragment slots and, at
    f32, the 3xTF32 split (B's from the packed slots; lo(a) hi(b) and
    hi(a) lo(b) each into its own accumulator, one for even and one for odd
    K steps of a slab; hi(a) hi(b) summed over the two K steps of a trip
    and added to a third; each product summed in f64 and rounded to f32).
    Returns (w, xi) and how often each padded output was written."""
    ncols, nz = x.shape
    kh = _ceil(nz, 8) * 8
    K = 2 * kh
    f32 = x.dtype == torch.float32
    a_all = torch.zeros((ncols, K), dtype=x.dtype)
    a_all[:, :nz], a_all[:, kh:kh + nz] = x, w
    out = torch.full((ncols, K), float("nan"), dtype=x.dtype)
    hits = torch.zeros((ncols, K), dtype=torch.int64)
    ntiles = _ceil(ncols, 16)
    for b, r in itertools.product(range(p.blocks), range(p.rg)):
        for tile in range(b + p.blocks * r, ntiles, p.blocks * p.rg):
            rows = slice(tile * 16, min(ncols, (tile + 1) * 16))
            a = a_all[rows]
            hh = torch.zeros((a.shape[0], K), dtype=x.dtype)
            lh = [torch.zeros_like(hh), torch.zeros_like(hh)]  # even, odd K steps
            hl = [torch.zeros_like(hh), torch.zeros_like(hh)]
            for kb0 in range(0, K // 8, p.kslab // 8):
                for kb in range(kb0, min(K // 8, kb0 + p.kslab // 8)):
                    slots = packed[kb]  # [K/8, 32, 2|4]
                    # slot [nt, g*4 + t, h] -> B[k = 4h + t][n = 8 nt + g]; at
                    # f32 h = 0, 1 hold hi, h = 2, 3 lo
                    bk = slots.reshape(K // 8, 8, 4, -1).permute(3, 2, 0, 1)
                    ak = a[:, kb * 8:(kb + 1) * 8]
                    if not f32:
                        hh += ak @ bk.reshape(8, K)
                        continue
                    b_hi = bk[:2].reshape(8, K).double()
                    b_lo = bk[2:].reshape(8, K).double()
                    a_hi = _tf32(ak)
                    a_lo = _tf32(ak - a_hi).double()
                    a_hi = a_hi.double()
                    q = (kb - kb0) % 2
                    lh[q] = (lh[q].double() + a_lo @ b_hi).float()
                    hl[q] = (hl[q].double() + a_hi @ b_lo).float()
                    if q == 0:
                        part = (a_hi @ b_hi).float()
                    else:
                        part = (part.double() + a_hi @ b_hi).float()
                        hh = hh + part
            out[rows] = hh + ((lh[0] + lh[1]) + (hl[0] + hl[1])) if f32 else hh
            hits[rows] += 1
    return (out[:, :nz], out[:, kh:kh + nz]), hits


# (ncols, nz): chip_smoke.py's shapes where the emulation stays quick, the
# moist3d and TC shapes, and large nz (M streamed in slabs)
EMULATED = [(37, 13), (1200, 24), (37, 40), (9216, 48), (300, 100), (37, 128),
            (300, 128)]


@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
@pytest.mark.parametrize("ncols,nz", EMULATED)
def test_plan_decomposition_matches_the_chain(ncols, nz, dtype):
    o64 = tti.build_semiimplicit_ops(nz, 0.0, 10000.0, None, 9.0e4, 0.15,
                                     torch.float64, "cpu")
    ot = tti.build_semiimplicit_ops(nz, 0.0, 10000.0, None, 9.0e4, 0.15, dtype, "cpu")
    x, w = _columns(ncols, nz, ncols + nz)
    ops64, ts_term = _stage_ops(o64, "ab")
    ref = column_solve.fused_column_solve_plain(x, w, *ops64, ts_term, o64.pxi_bar)
    p = column_solve.plan(ncols, nz, dtype)
    got, hits = _emulate(x.to(dtype), w.to(dtype), ot.solve.packed, p)
    assert torch.equal(hits, torch.ones_like(hits)), p  # every output once
    err = _max_rel(got, ref)
    if dtype == torch.float64:
        assert err <= 1e-13, (p, err)
    else:
        ops32, _ = _stage_ops(ot, "ab")
        chain32 = column_solve.fused_column_solve_plain(
            x.float(), w.float(), *ops32, ts_term, ot.pxi_bar)
        assert err <= 4.0 * _max_rel(chain32, ref) and err <= 1e-5, (p, err)


def test_pack_operator_slots_are_the_fragments():
    """slot [kb, nt, g*4 + t] holds M[8 nt + g][8 kb + t] and
    M[8 nt + g][8 kb + 4 + t], the halves of M padded to up8(nz)."""
    nz = 13
    m = torch.arange(4 * nz * nz, dtype=torch.float64).reshape(2 * nz, 2 * nz) + 1.0
    packed = column_solve.pack_operator(m, torch.float64)
    assert packed.shape == (4, 4, 32, 2)

    def real(i):  # padded index -> index into M, None in the padding
        half, j = divmod(i, 16)
        return half * nz + j if j < nz else None

    for kb, nt, lane, h in itertools.product(range(4), range(4), range(32), range(2)):
        n, k = real(8 * nt + lane // 4), real(8 * kb + 4 * h + lane % 4)
        want = 0.0 if n is None or k is None else float(m[n, k])
        assert float(packed[kb, nt, lane, h]) == want
    # f32: hi + lo reproduces float32(M) to the split's 2^-22, and hi is TF32
    p32 = column_solve.pack_operator(m, torch.float32)
    hi, lo = p32[..., :2], p32[..., 2:]
    assert torch.equal(hi, _tf32(hi))
    assert ((hi.double() + lo.double()) - packed.float().double()).abs().max() <= (
        2.0 ** -22 * m.abs().max())


def test_tf32_split_is_nearest_ties_away_and_exact_to_2_22():
    one = 1.0 + 2.0 ** -10  # a TF32 value: 10 mantissa bits
    v = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 2.0 ** -11), one],
                     dtype=torch.float32)
    assert _tf32(v).tolist() == [one, 1.0, -one, one]
    r = torch.from_numpy(np.random.default_rng(5).normal(size=4096)).float()
    hi = _tf32(r)
    lo = _tf32(r - hi)
    err = (hi.double() + lo.double() - r.double()).abs()
    assert (err <= 2.0 ** -22 * r.double().abs()).all()


@pytest.mark.parametrize("t", [1, 2, 5])
def test_adjustment_on_the_composed_path(monkeypatch, t):
    """semiimplicit_adjustment hands each stage's operator to the column
    solve: its packed M applied as the kernel applies it (the emulation)
    matches the JAX package's einsum path at f64."""
    nz, ncols, ts, pxi = 24, 37, 0.2, 9.0e4
    oj, ot = _ops(nz, ts, pxi)
    seen = []

    def composed(x, w, op):
        seen.append(op)
        got, _ = _emulate(x, w, op.packed, column_solve.plan(x.shape[0], nz, x.dtype))
        return got

    monkeypatch.setattr(column_solve, "apply_column_operator", composed)
    rng = np.random.default_rng(t)
    args = [rng.normal(size=(ncols, nz)) for _ in range(8)]
    wj, xj = jti.semiimplicit_adjustment(oj, *map(jnp.asarray, args), jnp.asarray(t))
    wt, xt = tti.semiimplicit_adjustment(ot, *map(torch.from_numpy, args), t)
    assert seen[0] is (ot.solve_t1 if t == 1 else ot.solve)
    assert _rel_err(wt, wj) <= 1e-10 and _rel_err(xt, xj) <= 1e-10


@pytest.mark.parametrize("nz,ncols,tile", [(24, 37, 16), (40, 96, 32)])
@pytest.mark.parametrize("stage", ["t1", "ab"])
def test_composed_path_matches_pallas_interpret(nz, ncols, tile, stage):
    ts, pxi = 0.2, 9.0e4
    oj, ot = _ops(nz, ts, pxi)
    ts_term, hj, packed = (
        (0.5 * ts, oj.hinv_t1, ot.solve_t1.packed) if stage == "t1"
        else (1.25 * ts, oj.hinv, ot.solve.packed)
    )
    x, w = _columns(ncols, nz, ncols)
    wk, xk = pallas_solve(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), oj.col_filter, oj.col_deriv,
        hj, oj.synth, oj.dsynth, ts_term, pxi, interpret=True, tile=tile, mode="plain",
    )
    got, _ = _emulate(x, w, packed, column_solve.plan(ncols, nz, torch.float64))
    for g, ref in zip(got, (wk, xk)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(g.numpy(), ref, atol=2e-4 * np.abs(ref).max(), rtol=1e-7)


# ---- the comp mode: bf16x3 of the composed M


@pytest.mark.parametrize("nz,ncols", [(40, 96), (24, 37), (13, 37)])
@pytest.mark.parametrize("stage", ["t1", "ab"])
def test_comp_matches_pallas_comp_interpret(nz, ncols, stage):
    """fused_column_solve at its default mode (comp: the bf16x3 product of
    the composed M, on the CPU its plain version) against the TPU kernel's
    _kernel_comp in interpret mode (five operators each split) at the JAX
    test's comp bar, and against the f64 chain within 5e-5 of max|ref|
    (bf16x3 grade; the Pallas comp kernel is 1.1e-5 to 1.6e-5 from it at
    nz 40)."""
    ts, pxi = 0.2, 9.0e4
    oj, ot = _ops(nz, ts, pxi)
    ts_term, hj, ht = ((0.5 * ts, oj.hinv_t1, ot.hinv_t1) if stage == "t1"
                       else (1.25 * ts, oj.hinv, ot.hinv))
    x, w = _columns(ncols, nz, ncols + 1)
    wk, xk = pallas_solve(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), oj.col_filter, oj.col_deriv, hj,
        oj.synth, oj.dsynth, ts_term, pxi, interpret=True, mode="comp")
    ops = (ot.col_filter, ot.col_deriv, ht, ot.synth, ot.dsynth)
    before = column_solve.comp_launches
    got = column_solve.fused_column_solve(x.float(), w.float(), *(o.float() for o in ops),
                                          ts_term, pxi)
    assert column_solve.comp_launches == before  # the CPU takes the plain version
    ref = column_solve.fused_column_solve_plain(x, w, *ops, ts_term, pxi)
    for g, k, r in zip(got, (wk, xk), ref):
        k = np.asarray(k)
        np.testing.assert_allclose(g.double().numpy(), k, atol=1e-2 * np.abs(k).max(),
                                   rtol=1e-4)
        assert _rel_err(g.double(), r) <= 5e-5


def _unpack_comp(packed):
    """(B_hi, B_lo) [K, N] float64, B[k][n] = M[n][k] padded, from the comp
    packing: slot [nt, ks, g*4 + t] holds (hi, lo) x (h, e) of k = 16 ks +
    8 h + 2 t + e, n = 8 nt + g."""
    nt, ks = packed.shape[:2]
    f = packed.double().reshape(nt, ks, 8, 4, 2, 2, 2)  # nt ks g t part h e
    b = f.permute(4, 1, 5, 3, 6, 0, 2).reshape(2, 16 * ks, 8 * nt)
    return b[0], b[1]


def test_comp_pack_operator_is_the_bf16_split():
    """The comp packing holds M's bf16 split in the m16n8k16 B-fragment
    order, n-tile major: hi and lo equal to the JAX package's _split of
    float32(M) bit for bit, each half of M zero-padded to up8(nz), hi + lo
    within 2^-16 of float32(M).  nz 13 (up8 16) and nz 20 (up8 24: a 16-deep
    K step spans the x*/w* seam)."""
    from scythe_tpu.ops.pallas_semiimplicit import _split

    for nz in (13, 20):
        kh = _ceil(nz, 8) * 8
        m = torch.from_numpy(np.random.default_rng(8).normal(size=(2 * nz, 2 * nz)))
        p32 = column_solve.pack_operator(m, torch.float32, "bf16")
        assert p32.dtype == torch.bfloat16 and p32.shape == (kh // 4, kh // 8, 32, 8)
        bh, bl = _unpack_comp(p32)
        jh, jl = (torch.from_numpy(np.asarray(o, np.float64)) for o in _split(jnp.asarray(
            m.numpy())))
        idx = torch.cat([torch.arange(nz), kh + torch.arange(nz)])
        for b, j in ((bh, jh), (bl, jl)):
            want = torch.zeros((2 * kh, 2 * kh), dtype=torch.float64)
            want[idx[:, None], idx[None, :]] = j.T
            assert torch.equal(b, want)
        hi, lo = bh[idx[:, None], idx[None, :]].T, bl[idx[:, None], idx[None, :]].T
        assert torch.equal(hi, bf16_round(hi.float()).double())
        assert ((hi + lo) - m.float().double()).abs().max() <= 2.0 ** -16 * m.abs().max()
    # the slot of lane g*4 + t: b0 = M[n][16 ks + 2t, +1], b1 = M[n][16 ks + 2t + 8,
    # +9], hi then lo (integers to 1024: hi + lo is exact)
    m = torch.arange(1.0, 1025.0, dtype=torch.float64).reshape(32, 32)
    p32 = column_solve.pack_operator(m, torch.float32, "bf16")
    for nt, ks, lane in itertools.product(range(4), range(2), range(32)):
        g, t = divmod(lane, 4)
        n, k = 8 * nt + g, 16 * ks + 2 * t
        got = p32[nt, ks, lane].double()
        assert (got[:4] + got[4:]).tolist() == [
            m[n, k].item(), m[n, k + 1].item(), m[n, k + 8].item(), m[n, k + 9].item()]


def _emulate_comp(x, w, packed, p):
    """The comp kernel's body, block by block in its order: for each block
    (its column range and N part) and row group, its 16-column tiles; each
    tile's [x* | w*] split once into bf16 hi and lo (the padded layout, zero
    past nz and past the tile's rows), then for each 16-deep K step, with B
    read from the packed fragments: hi·hi from zero (summed in f64, rounded
    to f32, as the tensor cores' product of one instruction) added to its
    f32 sum in round to nearest; lo·hi and hi·lo each accumulated in an f32
    accumulator of its own; out = hh + (lh + hl).  Returns (w, xi) and how
    often each output was written."""
    ncols, nz = x.shape
    kh = _ceil(nz, 8) * 8
    K = 2 * kh
    nb = K // p.nsplit
    a_all = torch.zeros((ncols, K), dtype=torch.float32)
    a_all[:, :nz], a_all[:, kh:kh + nz] = x, w
    out = torch.full((ncols, K), float("nan"), dtype=torch.float32)
    hits = torch.zeros((ncols, K), dtype=torch.int64)
    bh, bl = _unpack_comp(packed)
    for b in range(p.blocks):
        part = b % p.nsplit
        lo = (b // p.nsplit) * p.span
        hi = min(ncols, lo + p.span)
        n_cols = slice(part * nb, (part + 1) * nb)
        for r in range(p.rg):
            for tile in range(r, _ceil(hi - lo, 16), p.rg):
                rows = slice(lo + 16 * tile, min(hi, lo + 16 * (tile + 1)))
                a = torch.zeros((16, K), dtype=torch.float32)
                a[: rows.stop - rows.start] = a_all[rows]
                a_hi = bf16_round(a)
                a_lo = bf16_round(a - a_hi).double()
                a_hi = a_hi.double()
                hh, lh, hl = (torch.zeros((16, nb), dtype=torch.float32) for _ in range(3))
                for ks in range(K // 16):
                    k = slice(16 * ks, 16 * (ks + 1))
                    hh = hh + (a_hi[:, k] @ bh[k, n_cols]).float()
                    lh = (lh.double() + a_lo[:, k] @ bh[k, n_cols]).float()
                    hl = (hl.double() + a_hi[:, k] @ bl[k, n_cols]).float()
                n = rows.stop - rows.start
                out[rows, n_cols] = (hh + (lh + hl))[:n]
                hits[rows, n_cols] += 1
    return (out[:, :nz], out[:, kh:kh + nz]), hits[:, torch.cat(
        [torch.arange(nz), kh + torch.arange(nz)])]


@pytest.mark.parametrize("ncols,nz", [(37, 13), (1200, 24), (9216, 48), (300, 128),
                                     (37, 20), (1201, 20), (13824, 24)])
def test_comp_decomposition_matches_plain_comp(ncols, nz):
    """The comp kernel's decomposition (its own plan, plan_comp, and its
    m16n8k16 packing, emulated block by block: _emulate_comp) against its
    plain version (apply_column_operator_comp_plain): the same products
    summed in another order, so within 1e-6 of max|ref| (f32 round-off);
    every output once.  nz 20: a 16-deep K step spans the x*/w* seam; nz
    128: N split in two; 1201 columns: a last tile not whole 16-byte units."""
    ot = tti.build_semiimplicit_ops(nz, 0.0, 10000.0, None, 9.0e4, 0.15, torch.float64,
                                    "cpu")
    op = column_solve.column_operator(ot.solve.M, torch.float32, "cpu", "comp")
    assert op.comp and torch.equal(op.packed, column_solve.pack_operator(
        ot.solve.M, torch.float32, "bf16"))
    x, w = (t.float() for t in _columns(ncols, nz, ncols + nz + 1))
    p = column_solve.plan_comp(ncols, nz)
    got, hits = _emulate_comp(x, w, op.packed, p)
    ref = column_solve.apply_column_operator_comp_plain(x, w, op.M)
    assert torch.equal(hits, torch.ones_like(hits)), p
    assert _max_rel(got, tuple(r.double() for r in ref)) <= 1e-6


def test_comp_mode_is_float32_only():
    m = torch.eye(26, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        column_solve.column_operator(m, torch.float64, "cpu", "comp")
    x = torch.zeros((8, 13), dtype=torch.float64)
    op = torch.eye(13, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        column_solve.fused_column_solve(x, x.clone(), op, op, op, op, op, 0.1, 1.0)
    with pytest.raises(ValueError, match="mode"):
        column_solve.fused_column_solve(x, x.clone(), op, op, op, op, op, 0.1, 1.0,
                                        mode="bf16")


def test_comp_autograd_rules_take_the_comp_map():
    """A comp operator's backward is the comp map of M^T on the cotangents,
    its jvp the comp map on the tangents, its vmap the members folded into
    the columns (the CPU runs the formulas the card runs)."""
    ot = tti.build_semiimplicit_ops(16, 0.0, 10000.0, None, 9.0e4, 0.15, torch.float64,
                                    "cpu")
    op = column_solve.column_operator(ot.solve.M, torch.float32, "cpu", "comp")
    x, w = (t.float() for t in _columns(5, 16, 3))
    gw, gx = (t.float() for t in _columns(5, 16, 4))
    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = column_solve.apply_column_operator(xs, ws, op)
    assert type(out[0].grad_fn).__name__ == "ColumnSolveFnBackward"
    ga, gb = torch.autograd.grad(out, (xs, ws), (gw, gx))
    want = column_solve.apply_column_operator_comp_plain(gw, gx, op.M.T.contiguous())
    assert torch.equal(ga, want[0]) and torch.equal(gb, want[1])
    _, tang = torch.func.jvp(lambda a, b: column_solve.apply_column_operator(a, b, op),
                             (x, w), (gw, gx))
    want = column_solve.apply_column_operator_comp_plain(gw, gx, op.M)
    assert torch.equal(tang[0], want[0]) and torch.equal(tang[1], want[1])
    xb, wb = torch.stack([x, 2 * x]), torch.stack([w, -w])
    vm = torch.func.vmap(lambda a, b: column_solve.apply_column_operator(a, b, op))(xb, wb)
    for i in range(2):
        one = column_solve.apply_column_operator(xb[i], wb[i], op)
        assert torch.equal(vm[0][i], one[0]) and torch.equal(vm[1][i], one[1])


PLAN_COMP_NCOLS = (1, 37, 1200, 9216, 13824)


@pytest.mark.parametrize("ncols", PLAN_COMP_NCOLS)
def test_comp_plan_fits_the_card_and_covers_every_column(ncols):
    """plan_comp at nz 3-128: its shared memory is the kernel's layout and
    fits 232,448 bytes, its threads the register budget (128 a thread, one
    block an SM, one wave), its barriers their 256 bytes, and its blocks and
    row groups cover every column of every N part once, no block more than
    4 columns over its share."""
    for nz in range(3, column_solve.MAX_NZ + 1):
        p = column_solve.plan_comp(ncols, nz)
        where = (ncols, nz, p)
        nb8 = 2 * _ceil(nz, 8) // p.nsplit
        assert p.smem == column_solve.comp_smem_bytes(nz, p.nsplit, p.rg), where
        assert p.smem <= column_solve.SMEM_MAX, where
        assert p.nsplit in (1, 2) and p.ntw in (2, 4) and p.span % 4 == 0, where
        assert p.threads == p.rg * 32 * _ceil(nb8, p.ntw) <= column_solve.COMP_MAX_THREADS
        assert p.threads * column_solve.COMP_MAX_REGS <= column_solve.REGS_SM, where
        assert 1 + p.rg <= column_solve.BARRIER_BYTES // 8, where
        assert 1 <= p.rg <= min(column_solve.COMP_MAX_RG, _ceil(min(p.span, ncols), 16))
        assert p.blocks == p.nsplit * _ceil(ncols, p.span) <= column_solve.NUM_SMS, where
        ranges = column_solve.NUM_SMS // p.nsplit
        assert p.span <= (ncols + 3) / ranges + 4, where
        hits = np.zeros((ncols, p.nsplit), dtype=np.int64)
        for b in range(p.blocks):
            lo = (b // p.nsplit) * p.span
            hi = min(ncols, lo + p.span)
            for r in range(p.rg):
                for tile in range(r, _ceil(hi - lo, 16), p.rg):
                    hits[lo + 16 * tile:min(hi, lo + 16 * (tile + 1)), b % p.nsplit] += 1
        assert (hits == 1).all(), where


def test_comp_plan_at_the_main_path_shapes():
    """The timed shapes: one block a contiguous run of columns, 72 at
    moist3d (128 blocks, against 576 tiles of 16 over 132 SMs), M resident
    and N whole, a row group for every tile; nz 128 splits N in two."""
    moist3d = column_solve.plan_comp(9216, 48)
    assert (moist3d.span, moist3d.blocks, moist3d.nsplit) == (72, 128, 1)
    assert moist3d.rg == 5
    jw06 = column_solve.plan_comp(13824, 24)
    assert jw06.span == 108 and jw06.rg == 7
    assert column_solve.plan_comp(9216, 128).nsplit == 2


def _adjust_args(nz, ncols, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(ncols, nz)) for _ in range(8)]


@pytest.mark.parametrize("t", [1, 2, 5])
@pytest.mark.parametrize("nz,ncols", [(24, 37), (40, 96)])
def test_use_pallas_adjustment_matches_pallas_comp_interpret(monkeypatch, nz, ncols, t):
    """build_semiimplicit_ops(..., use_pallas=True): semiimplicit_adjustment
    applies the comp map (on the CPU the comp kernel's plain version) and
    matches the JAX package's adjustment with use_pallas=True, whose Pallas
    comp kernel runs here in interpret mode, at the JAX test's comp bar
    (atol 1e-2 of max|ref|, rtol 1e-4), and the f64 chain within 5e-5 of
    max|ref| (as test_comp_matches_pallas_comp_interpret)."""
    import functools

    from scythe_tpu.ops import pallas_semiimplicit

    monkeypatch.setattr(pallas_semiimplicit, "fused_column_solve",
                        functools.partial(pallas_solve, interpret=True))
    ts, pxi = 0.2, 9.0e4
    oj = jti.build_semiimplicit_ops(nz, 0.0, 10000.0, None, pxi, ts, jnp.float32,
                                    use_pallas=True)
    ot = tti.build_semiimplicit_ops(nz, 0.0, 10000.0, None, pxi, ts, torch.float32, "cpu",
                                    use_pallas=True)
    o64 = tti.build_semiimplicit_ops(nz, 0.0, 10000.0, None, pxi, ts, torch.float64, "cpu")
    assert oj.use_pallas and ot.solve.comp and ot.solve_t1.comp
    args = _adjust_args(nz, ncols, nz + t)
    wj, xj = jti.semiimplicit_adjustment(oj, *(jnp.asarray(a, jnp.float32) for a in args),
                                         jnp.asarray(t))
    before = column_solve.comp_launches
    got = tti.semiimplicit_adjustment(ot, *(torch.from_numpy(a).float() for a in args), t)
    assert column_solve.comp_launches == before  # the CPU takes the plain version
    ref = tti.semiimplicit_adjustment(o64, *map(torch.from_numpy, args), t)
    plain32 = tti.build_semiimplicit_ops(nz, 0.0, 10000.0, None, pxi, ts, torch.float32,
                                         "cpu")
    plain = tti.semiimplicit_adjustment(plain32, *(torch.from_numpy(a).float() for a in args), t)
    for g, k, r, q in zip(got, (wj, xj), ref, plain):
        k = np.asarray(k)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.double().numpy(), k, atol=1e-2 * np.abs(k).max(),
                                   rtol=1e-4)
        assert _rel_err(g.double(), r) <= 5e-5
        assert not torch.equal(g, q)  # the comp map, not the plain operator


def test_use_pallas_refuses_a_profile():
    """As the JAX package: the comp route takes a scalar Pxi only."""
    with pytest.raises(ValueError, match="scalar pxi"):
        tti.build_semiimplicit_ops(16, 0.0, 1.0e4, None, _profile(16), 0.2, torch.float32,
                                   "cpu", use_pallas=True)
    with pytest.raises(ValueError, match="scalar pxi"):
        jti.build_semiimplicit_ops(16, 0.0, 1.0e4, None, _profile(16), 0.2, jnp.float32,
                                   use_pallas=True)


@pytest.mark.parametrize("use_pallas", [None, False])
def test_use_pallas_default_takes_the_plain_operator(use_pallas):
    """None (the default) and False build the plain operators, so default
    runs are unchanged: the adjustment equals the one built without the
    keyword, bit for bit."""
    kw = {} if use_pallas is None else {"use_pallas": use_pallas}
    o = tti.build_semiimplicit_ops(24, 0.0, 1.0e4, None, 9.0e4, 0.2, torch.float32, "cpu",
                                   **kw)
    base = tti.build_semiimplicit_ops(24, 0.0, 1.0e4, None, 9.0e4, 0.2, torch.float32, "cpu")
    for op in (o.solve, o.solve_t1):
        assert not op.comp
        assert torch.equal(op.packed, column_solve.pack_operator(op.M.double(), torch.float32))
    args = [torch.from_numpy(a).float() for a in _adjust_args(24, 37, 4)]
    for a, b in zip(tti.semiimplicit_adjustment(o, *args, 5),
                    tti.semiimplicit_adjustment(base, *args, 5)):
        assert torch.equal(a, b)
