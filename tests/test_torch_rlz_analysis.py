"""The RLZ analysis of the port (ops.rlz_analysis, Grid.analysis on RLZ)
against the JAX package: its plain version against the fused Pallas kernel
run as tests/test_pallas_transforms.py runs it (interpret mode on a
``matmul="compensated"`` f32 grid: bf16x3 operators, so agreement is at f32
round-off, bound 1e-4 of max|ref|), and against the JAX plain-mode float64
``grid.analysis`` (1e-12 of max|ref|); its comp mode (the TPU kernel's own
bf16x3 arithmetic, on a compensated port grid) against the same Pallas
kernel at tests/test_pallas_transforms.py's 1e-5.  The plan is swept and
its decomposition emulated block by block in both modes.  The CUDA kernel
itself runs only on the card: chip_smoke.py holds it against these plain
versions there."""

import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import scythe_tpu as jx
from scythe_tpu.ops import pallas_transforms as pt
import scythe_tpu_torch as tx
from scythe_tpu_torch.ops import rlz_analysis as ra
from scythe_tpu_torch.ops.bf16x3 import comp_einsum

torch.set_num_threads(2)

SHAPES = [(4, 16, 64, 20), (2, 12, 32, 16)]  # nvars, cells, nl, nz


def _params(pkg, nvars, cells, nl, nz):
    return pkg.GridParameters(
        geometry="RLZ", xmin=0.0, xmax=3.0e5, num_cells=cells, lDim=nl,
        zmin=0.0, zmax=1.0e4, zDim=nz,
        vars={n: i + 1 for i, n in enumerate("abcdefghi"[:nvars])},
    )


def _ops(grid):
    return (grid.l_analysis, grid.ring_mask, grid.analysis_r, grid.analysis_z)


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("nvars,cells,nl,nz", SHAPES)
def test_plain_matches_pallas_interpret(nvars, cells, nl, nz):
    gj = jx.create_grid(_params(jx, nvars, cells, nl, nz), jnp.float32,
                        matmul="compensated")
    gt = tx.create_grid(_params(tx, nvars, cells, nl, nz), torch.float64, device="cpu")
    rng = np.random.default_rng(0)
    phys = rng.normal(size=(nvars,) + gt.spatial_shape).astype(np.float32)
    want = np.asarray(pt.build_rlz_analysis(gj, interpret=True)(jnp.asarray(phys)))
    got = ra.rlz_analysis_plain(torch.from_numpy(phys.astype(np.float64)), *_ops(gt))
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("nvars,cells,nl,nz", SHAPES + [(9, 8, 16, 16)])
def test_comp_plain_matches_pallas_interpret(nvars, cells, nl, nz):
    """The comp mode's plain chain, on a compensated port grid, against the
    TPU kernel run in interpret mode on the JAX compensated grid (the same
    bf16 operator halves, the activation split before each contraction):
    1e-5 of max|ref|, tests/test_pallas_transforms.py's bar."""
    gj = jx.create_grid(_params(jx, nvars, cells, nl, nz), jnp.float32,
                        matmul="compensated")
    gt = tx.create_grid(_params(tx, nvars, cells, nl, nz), torch.float32,
                        matmul="compensated", device="cpu")
    phys = np.random.default_rng(7).normal(size=(nvars,) + gt.spatial_shape).astype(
        np.float32)
    want = np.asarray(pt.build_rlz_analysis(gj, interpret=True)(jnp.asarray(phys)))
    got = ra.rlz_analysis(torch.from_numpy(phys), *_ops(gt), mode="comp")
    assert torch.equal(got, gt.analysis(torch.from_numpy(phys)))
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("nvars,cells,nl,nz", SHAPES + [(9, 8, 16, 16)])
def test_plain_matches_jax_plain_analysis_f64(nvars, cells, nl, nz):
    gj = jx.create_grid(_params(jx, nvars, cells, nl, nz), jnp.float64, matmul="plain")
    gt = tx.create_grid(_params(tx, nvars, cells, nl, nz), torch.float64, device="cpu")
    phys = np.random.default_rng(nvars).normal(size=(nvars,) + gt.spatial_shape)
    want = np.asarray(gj.analysis(jnp.asarray(phys)))
    got = ra.rlz_analysis_plain(torch.from_numpy(phys), *_ops(gt))
    assert _rel(got, want) <= 1e-12


def test_grid_analysis_takes_the_wrapper_plain_path_on_cpu():
    gt = tx.create_grid(_params(tx, 3, 8, 16, 12), torch.float64, device="cpu")
    phys = torch.from_numpy(np.random.default_rng(5).normal(size=(3,) + gt.spatial_shape))
    before = ra.launches
    got = gt.analysis(phys)
    assert ra.launches == before  # CPU tensors never launch the kernel
    assert torch.equal(got, ra.rlz_analysis_plain(phys, *_ops(gt)))
    assert torch.equal(got, ra.rlz_analysis(phys, *_ops(gt)))
    # project + solve_spectral (kept on einsum) still compose to the analysis
    rebuilt = gt.solve_spectral(gt.project(phys))
    assert _rel(rebuilt, got) <= 1e-12


def test_other_geometries_keep_the_einsum_path():
    gp = tx.GridParameters(geometry="RZ", xmin=0.0, xmax=1.0e4, num_cells=6,
                           zmin=0.0, zmax=1.0e4, zDim=10, vars={"a": 1})
    g = tx.create_grid(gp, torch.float64, device="cpu")
    phys = torch.ones((1,) + g.spatial_shape, dtype=torch.float64)
    before = ra.launches
    assert g.analysis(phys).shape == g.spectral_shape
    assert ra.launches == before


def _rejects(match, phys, ops):
    with pytest.raises(ValueError, match=match):
        ra.rlz_analysis(phys, *ops)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    gt = tx.create_grid(_params(tx, 2, 8, 16, 12), torch.float64, device="cpu")
    ops = _ops(gt)
    phys = torch.zeros((2,) + gt.spatial_shape, dtype=torch.float64)
    _rejects("rDim, nl, nz", phys[0], ops)
    _rejects("dtype", phys.half(), ops)
    _rejects("float32", phys.float(), ops)
    _rejects("analysis_r", phys[:1], ops)  # one var against two-var operators
    _rejects("ring_mask", phys[:, :-1], ops)
    _rejects("analysis_z", phys[..., :-1], ops)
    meta = torch.empty(phys.shape, dtype=phys.dtype, device="meta")
    _rejects("device|cpu", meta, tuple(o.to("meta") for o in ops))


# ---- the kernel's plan (pure Python) and its decomposition, on the CPU


def _ceil(a, b):
    return -(-a // b)


PLAN_NZ = (1, 13, 24, 32, 48, 60, 128)
PLAN_NL = (1, 4, 12, 16, 64, 96, 128, 1024, 2048)
PLAN_VRB = ((3, 21, 10), (9, 36, 15), (9, 72, 27), (9, 144, 51), (9, 300, 103),
            (8, 192, 67), (1, 600, 203))


def _check_plans(dtype, nz, mode):
    es = torch.empty((), dtype=dtype).element_size()
    for nl, (V, R, B) in itertools.product(PLAN_NL, PLAN_VRB):
        p = ra.plan((V, R, nl, nz), B, dtype, mode)
        where = (dtype, mode, V, R, nl, nz, B, p)
        assert p.smem <= 232_448, where
        if mode == "comp":
            # two regions: the coefficients (then the reduced rows) and the
            # ring of x (with the partial sums over it, or after it)
            region_a, region_b = ra.comp_smem_layout(nz, R, p.kt, p.bt, p.c, p.rc, p.rp, p.lc,
                                                     p.st)
            assert p.smem == ra.BARRIER_BYTES + region_a + region_b, where
        else:
            acc, stage, epilogue = ra.smem_layout(nz, es, p.kt, p.bt, p.c, p.rc, p.lc, p.zc,
                                                  p.st)
            assert p.smem == ra.BARRIER_BYTES + acc + max(stage, epilogue), where
        assert 2 <= p.st <= ra.MAX_ST, where
        assert 1 <= p.c <= 8 and p.c <= R and p.grid[0] % p.c == 0, where
        assert 1 <= p.kt <= min(nl, ra.MAX_KT) and 1 <= p.bt <= B, where
        assert 1 <= p.lc <= nl and 1 <= p.zc <= nz, where
        if mode == "comp":
            # tensor-core tiles: k-tiles of 8 or 16 (or all of nl), b-tiles
            # of 16-row A tiles (or all of b_rDim), r-slices on 16 rows
            # (none empty) as one chunk or in chunks of 16-64 rows, each in
            # pieces of rp rows; l-pieces of 16-deep k-steps (or all of nl),
            # analysis_z staged whole; the lambda m-tiles fit the warps'
            # registers
            rs = ra.comp_slice_rows(R, p.c)
            assert p.kt % 8 == 0 or p.kt == nl, where
            assert p.bt % 16 == 0 or p.bt == B, where
            assert p.rc % 16 == 0 and p.rc % p.rp == 0 and p.rp % 2 == 0, where
            assert p.rc == rs <= ra.COMP_MAX_RC or 16 <= p.rc <= 64, where
            assert p.lc % 16 == 0 or p.lc == nl, where
            assert p.zc == nz and p.threads in ra.COMP_THREADS, where
            assert rs == _ceil(_ceil(R, p.c), 16) * 16 and (p.c - 1) * rs < R, where
            assert ra.comp_items_fit(nz, p.kt, p.rp, p.threads), where
        else:
            assert 1 <= p.rc <= ra.MAX_RC, where
            # one lambda tile (4 k x 4 z) a consumer thread at most
            assert p.rp == p.rc and p.rc * ra.lanes_a_row(p.kt, nz) <= p.threads - 32, where
            assert p.threads in ra.THREADS
        # the grid's tiles cover every (b, k) once; the cluster's shares
        # cover every row of a tile
        assert p.grid == (p.c, _ceil(nl, p.kt) * _ceil(B, p.bt), V), where
        assert (_ceil(nl, p.kt) - 1) * p.kt < nl and (_ceil(B, p.bt) - 1) * p.bt < B
        assert p.c * _ceil(p.bt * p.kt, p.c) >= p.bt * p.kt
        assert (p.c - 1) * _ceil(R, p.c) < R or p.c == 1, where


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("nz", PLAN_NZ)
def test_plan_fits_the_card_and_covers_the_output(dtype, nz):
    _check_plans(dtype, nz, "plain")


@pytest.mark.parametrize("nz", PLAN_NZ)
def test_comp_plan_fits_the_card_and_covers_the_output(nz):
    """The comp mode's plans (its own tensor-core body: pieces of x in f32,
    the operators' bf16 fragments, the coefficients split into bf16 hi and
    lo, f32 partial sums) under the same checks and the tensor-core
    tiling's own; the mode is float32 only."""
    _check_plans(torch.float32, nz, "comp")
    with pytest.raises(ValueError, match="float32"):
        ra.plan((9, 144, 64, 48), 51, torch.float64, "comp")
    # moist3d: r split over a cluster, x read at most 16 times (k-tiles by
    # b-tiles), one block of 15 consumer warps an SM
    p = ra.plan((9, 144, 64, 48), 51, torch.float32, "comp")
    assert p.c > 1 and p.threads == 512, p
    assert _ceil(64, p.kt) * _ceil(51, p.bt) <= 16, p


def test_plan_meets_its_goals_at_the_main_path_shapes():
    f32 = torch.float32
    moist3d = ra.plan((9, 144, 64, 48), 51, f32)
    tc = ra.plan((9, 300, 4, 24), 103, f32)
    transform = ra.plan((8, 192, 128, 60), 67, f32)
    # r split over a cluster; x read 8x from L2 at moist3d, 16x at the
    # transform shape, with the whole of b_rDim in one tile
    assert (moist3d.kt, moist3d.bt) == (8, 51) and moist3d.c > 1
    assert transform.kt >= 8 and transform.bt == 67 and transform.c > 1
    # one block an SM where the accumulator is large, and the grid in whole
    # waves (117 blocks a wave in clusters of 3, 132 in clusters of 2)
    assert moist3d.threads == transform.threads == 512
    assert moist3d.ctas <= 2 * 117 and transform.ctas <= 2 * 132
    # the TC grid: a small accumulator, two blocks an SM, one wave of
    # clusters of 8 (240 blocks)
    assert tc.kt == 4 and tc.c == 8 and tc.threads == 256
    assert tc.smem <= ra.SMEM_TWO_A_SM and 132 < tc.ctas <= 240
    # f64 halves what fits: moist3d's wavenumber tile halves
    assert ra.plan((9, 144, 64, 48), 51, torch.float64).kt == 4


def _emulate(phys, la, mask, an, az, p, mm=torch.einsum):
    """The plan's decomposition executed block by block, in the kernel's
    order: per-r-slice partials over r-chunks and l-chunks (each l-piece's
    product summed apart and added in f32, each r-chunk's likewise into
    the accumulator), a rank-order reduction of each block's share of the
    (b, k) rows, and the vertical stage in chunks of analysis_z rows.
    ``mm``: each product (comp_einsum with the comp mode's [3, ...] operator
    stacks: the activation split before it, as the comp kernel splits x as
    it reads it, the masked coefficients at the end of an r-chunk's
    l-pieces and the reduced rows; its r-slices start on 16 rows).  Returns
    the output and how often each (b, k) row was written."""
    V, R, L, Z = phys.shape
    B = an.shape[-2]
    out = torch.full((V, B, L, Z), float("nan"), dtype=phys.dtype)
    hits = torch.zeros((B, L), dtype=torch.int64)
    rs, share = _ceil(R, p.c), _ceil(p.bt * p.kt, p.c)
    if mm is comp_einsum:  # the comp kernel's r-slices start on 16 rows
        rs = _ceil(rs, 16) * 16
    for k0, b0 in itertools.product(range(0, L, p.kt), range(0, B, p.bt)):
        nk, nb = min(p.kt, L - k0), min(p.bt, B - b0)
        partials = []
        for j in range(p.c):  # the cluster's blocks
            acc = torch.zeros((V, nb, nk, Z), dtype=phys.dtype)
            r_lo = min(R, j * rs)
            r_hi = min(R, r_lo + rs)
            for r0 in range(r_lo, r_hi, p.rc):
                r1 = min(r0 + p.rc, r_hi)
                a = torch.zeros((V, r1 - r0, nk, Z), dtype=phys.dtype)
                for l0 in range(0, L, p.lc):
                    l1 = min(l0 + p.lc, L)
                    a = a + mm("kl,vrlz->vrkz", la[..., k0:k0 + nk, l0:l1],
                               phys[:, r0:r1, l0:l1])
                a = a * mask[r0:r1, k0:k0 + nk, None]
                acc = acc + mm("vbr,vrkz->vbkz", an[..., :, b0:b0 + nb, r0:r1], a)
            partials.append(acc.reshape(V, nb * nk, Z))
        for j in range(p.c):
            q0 = min(nb * nk, j * share)
            q1 = min(nb * nk, q0 + share)
            red = partials[0][:, q0:q1]
            for part in partials[1:]:  # rank order
                red = red + part[:, q0:q1]
            res = torch.empty_like(red)
            for K0 in range(0, Z, p.zc):  # analysis_z in chunks of rows
                res[..., K0:K0 + p.zc] = mm("vKz,vqz->vqK", az[..., :, K0:K0 + p.zc, :],
                                            red)
            q = torch.arange(q0, q1)
            b, k = b0 + q // nk, k0 + q % nk
            out[:, b, k] = res
            hits.index_put_((b, k), torch.ones_like(q), accumulate=True)
    return out, hits


# chip_smoke.py's analysis shapes (nvars, cells, nl, nz) and a ragged one;
# the XYZ shower, the SLZ test grid and the JW06 grid run the same function
# on their own operators, at these shapes
EMULATED = {
    "moist3d": (9, 48, 64, 48),
    "tc": (9, 100, 4, 24),
    "shower": (9, 48, 16, 32),
    "slz_test": (9, 12, 32, 24),
    "jw06": (9, 24, 96, 24),
    "transform": (8, 64, 128, 60),
    "pallas_test_a": (4, 16, 64, 20),
    "pallas_test_b": (2, 12, 32, 16),
    "large_nl": (2, 8, 1024, 16),
    "ragged": (3, 7, 12, 13),
}


@pytest.mark.parametrize("plan_dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("name", EMULATED)
def test_plan_decomposition_matches_plain_f64(name, plan_dtype):
    nvars, cells, nl, nz = EMULATED[name]
    gt = tx.create_grid(_params(tx, nvars, cells, nl, nz), torch.float64, device="cpu")
    phys = torch.from_numpy(
        np.random.default_rng(cells).normal(size=(nvars,) + gt.spatial_shape))
    p = ra.plan(phys.shape, gt.params.b_rDim, plan_dtype)
    got, hits = _emulate(phys, *_ops(gt), p)
    ref = ra.rlz_analysis_plain(phys, *_ops(gt))
    assert torch.equal(hits, torch.ones_like(hits)), p  # every output once
    assert _rel(got, ref) <= 1e-13, p


@pytest.mark.parametrize("name", ["moist3d", "tc", "shower", "jw06", "pallas_test_a",
                                  "large_nl", "ragged"])
def test_comp_plan_decomposition_matches_plain_comp(name):
    """The comp mode's decomposition, block by block with its bf16 splits,
    against its plain version (rlz_analysis_comp_plain) in f32: 2e-5 of
    max|ref| (measured up to 3.4e-6: the blocked sums round in another
    order, so a split may round an f32-rounded intermediate's hi part the
    other way, a bf16x2-sized step), and every output once."""
    nvars, cells, nl, nz = EMULATED[name]
    gt = tx.create_grid(_params(tx, nvars, cells, nl, nz), torch.float32,
                        matmul="compensated", device="cpu")
    phys = torch.from_numpy(np.random.default_rng(cells).normal(
        size=(nvars,) + gt.spatial_shape).astype(np.float32))
    p = ra.plan(phys.shape, gt.params.b_rDim, torch.float32, "comp")
    got, hits = _emulate(phys, *_ops(gt), p, mm=comp_einsum)
    ref = ra.rlz_analysis_comp_plain(phys, *_ops(gt))
    assert torch.equal(hits, torch.ones_like(hits)), p
    assert _rel(got, ref) <= 2e-5, (p, _rel(got, ref))


# ---- the comp kernel's packed operators (pure Python, on the CPU)


def _unpack_pairs(words):
    """int32 pairs of bf16 -> float32 [..., 2n] (the low half first)."""
    lo = (words & 0xFFFF).to(torch.int16)
    hi = ((words >> 16) & 0xFFFF).to(torch.int16)
    bits = torch.stack([lo, hi], dim=-1).reshape(*words.shape[:-1], -1)
    return bits.view(torch.bfloat16).float()


def _unpack_b(frags, n, k, lambda_order):
    """[..., K16/16, N8/8, 32, 2] B fragments back to [..., N, K]."""
    v = _unpack_pairs(frags)  # [..., ks, nt, 32, 4]: (g, t), (r, e)
    *lead, ks, nt = v.shape[:-2]
    d = len(lead)
    v = v.reshape(*lead, ks, nt, 8, 4, 2, 2)  # ks, nt, g, t, r, e
    if lambda_order:  # K within a step = t + 4 e + 8 r
        v = v.permute(*range(d), d + 1, d + 2, d, d + 4, d + 5, d + 3)
    else:  # 8 r + 2 t + e
        v = v.permute(*range(d), d + 1, d + 2, d, d + 4, d + 3, d + 5)
    return v.reshape(*lead, nt * 8, ks * 16)[..., :n, :k]


def _unpack_a(frags, m, k):
    """[..., M16/16, K16/16, 32, 4] A fragments back to [..., M, K]."""
    v = _unpack_pairs(frags)  # [..., mt, ks, 32, 8]: (g, t), (c, h, e)
    *lead, mt, ks = v.shape[:-2]
    d = len(lead)
    v = v.reshape(*lead, mt, ks, 8, 4, 2, 2, 2)  # mt, ks, g, t, c, h, e
    v = v.permute(*range(d), d, d + 5, d + 2, d + 1, d + 4, d + 3, d + 6)
    return v.reshape(*lead, mt * 16, ks * 16)[..., :m, :k]


PACKED = {"pallas_test_a": (4, 16, 64, 20), "tc": (9, 100, 4, 24), "ragged": (3, 7, 12, 13),
          "moist3d": (9, 48, 64, 48)}


@pytest.mark.parametrize("name", PACKED)
def test_comp_packing_round_trips_the_grid_stacks_bit_for_bit(name):
    """pack_comp_operators holds each operator's bf16 hi and lo exactly:
    unpacked, they equal the grid's [3, ...] stacks' O_hi and O_lo bit for
    bit, the padding is zero in both parts, and the fragments' shapes are
    the kernel's (16-deep k-steps, 8-wide n-tiles, 16-row m-tiles)."""
    nvars, cells, nl, nz = PACKED[name]
    g = tx.create_grid(_params(tx, nvars, cells, nl, nz), torch.float32,
                       matmul="compensated", device="cpu")
    V, B, R = g.analysis_r.shape[1:]
    packed = ra.pack_comp_operators(g.l_analysis, g.analysis_r, g.analysis_z)
    assert packed.nvars == V
    assert packed.la.shape == (_ceil(nl, 16), _ceil(nl, 8), 32, 4)
    assert packed.an.shape == (V, _ceil(B, 16), _ceil(R, 16), 2, 32, 4)
    assert packed.az.shape == (V, _ceil(nz, 16), _ceil(nz, 8), 32, 4)
    assert all(t.dtype == torch.int32 and t.is_contiguous() for t in packed[:3])
    for p in (0, 1):  # hi, lo
        la = _unpack_b(packed.la[..., 2 * p:2 * p + 2], _ceil(nl, 8) * 8, _ceil(nl, 16) * 16,
                       True)
        an = _unpack_a(packed.an[..., p, :, :], _ceil(B, 16) * 16, _ceil(R, 16) * 16)
        az = _unpack_b(packed.az[..., 2 * p:2 * p + 2], _ceil(nz, 8) * 8, _ceil(nz, 16) * 16,
                       False)
        for got, want in ((la, g.l_analysis[p]), (an, g.analysis_r[p]), (az, g.analysis_z[p])):
            n, k = want.shape[-2:]
            assert torch.equal(got[..., :n, :k].view(torch.int32), want.view(torch.int32))
            assert not got[..., n:, :].any() and not got[..., :, k:].any()


def test_comp_packing_is_made_once_per_grid():
    """comp_operators packs a grid's operators at its first call and hands
    the same tensors back after (the wrapper asks on every launch: no
    launch a call for the packing); an operator changed in place is packed
    again."""
    g = tx.create_grid(_params(tx, 2, 8, 16, 12), torch.float32, matmul="compensated",
                       device="cpu")
    ops = (g.l_analysis, g.analysis_r, g.analysis_z)
    before = ra.packs
    first = ra.comp_operators(*ops)
    assert ra.packs == before + 1
    again = ra.comp_operators(*ops)
    assert ra.packs == before + 1
    assert all(a is b for a, b in zip(first[:3], again[:3]))
    # another grid's operators are packed for themselves
    g2 = tx.create_grid(_params(tx, 2, 8, 16, 12), torch.float32, matmul="compensated",
                        device="cpu")
    ra.comp_operators(g2.l_analysis, g2.analysis_r, g2.analysis_z)
    assert ra.packs == before + 2
    g.analysis_z.mul_(1.0)  # a new version
    ra.comp_operators(*ops)
    assert ra.packs == before + 3
