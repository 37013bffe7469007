"""The RLZ analysis of the port (ops.rlz_analysis, Grid.analysis on RLZ)
against the JAX package: its plain version against the fused Pallas kernel
run as tests/test_pallas_transforms.py runs it (interpret mode on a
``matmul="compensated"`` f32 grid: bf16x3 operators, so agreement is at f32
round-off, bound 1e-4 of max|ref|), and against the JAX plain-mode float64
``grid.analysis`` (1e-12 of max|ref|).  The CUDA kernel itself runs only on
the card: chip_smoke.py holds it against this plain version there."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import scythe_tpu as jx
from scythe_tpu.ops import pallas_transforms as pt
import scythe_tpu_torch as tx
from scythe_tpu_torch.ops import rlz_analysis as ra

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
    gt = tx.create_grid(_params(tx, nvars, cells, nl, nz), torch.float64)
    rng = np.random.default_rng(0)
    phys = rng.normal(size=(nvars,) + gt.spatial_shape).astype(np.float32)
    want = np.asarray(pt.build_rlz_analysis(gj, interpret=True)(jnp.asarray(phys)))
    got = ra.rlz_analysis_plain(torch.from_numpy(phys.astype(np.float64)), *_ops(gt))
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("nvars,cells,nl,nz", SHAPES + [(9, 8, 16, 16)])
def test_plain_matches_jax_plain_analysis_f64(nvars, cells, nl, nz):
    gj = jx.create_grid(_params(jx, nvars, cells, nl, nz), jnp.float64, matmul="plain")
    gt = tx.create_grid(_params(tx, nvars, cells, nl, nz), torch.float64)
    phys = np.random.default_rng(nvars).normal(size=(nvars,) + gt.spatial_shape)
    want = np.asarray(gj.analysis(jnp.asarray(phys)))
    got = ra.rlz_analysis_plain(torch.from_numpy(phys), *_ops(gt))
    assert _rel(got, want) <= 1e-12


def test_grid_analysis_takes_the_wrapper_plain_path_on_cpu():
    gt = tx.create_grid(_params(tx, 3, 8, 16, 12), torch.float64)
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
    g = tx.create_grid(gp, torch.float64)
    phys = torch.ones((1,) + g.spatial_shape, dtype=torch.float64)
    before = ra.launches
    assert g.analysis(phys).shape == g.spectral_shape
    assert ra.launches == before


def _rejects(match, phys, ops):
    with pytest.raises(ValueError, match=match):
        ra.rlz_analysis(phys, *ops)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    gt = tx.create_grid(_params(tx, 2, 8, 16, 12), torch.float64)
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
