"""The port's Grid (plain mode) against scythe_tpu's on R / RL / RZ / RLZ:
analysis, project + solve_spectral, every synthesis slot and the column
helpers, float64 on the CPU, within 1e-12 of max|ref|."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import scythe_tpu as jx
import scythe_tpu_torch as tx

torch.set_num_threads(2)

REL = 1e-12

CASES = {
    "R": dict(geometry="R", xmin=0.0, xmax=100.0, num_cells=10,
              BCL={"u": "R1T0"}, BCR={"h": "R1T1"}, vars=("u", "h")),
    "RL": dict(geometry="RL", xmin=0.0, xmax=5.0e4, num_cells=6, lDim=24,
               BCL={"u": "R1T0", "v": "R1T0"}, BCR={"u": "R1T0"},
               vars=("h", "u", "v")),
    "RZ": dict(geometry="RZ", xmin=0.0, xmax=2.0e4, num_cells=5, zmin=0.0,
               zmax=1.0e4, zDim=12, BCL={"u": "R1T0", "w": "R1T1"},
               BCB={"w": "R1T0"}, BCT={"w": "R1T0", "s": "R1T1"},
               vars=("s", "u", "w")),
    "RLZ": dict(geometry="RLZ", xmin=0.0, xmax=1.0e4, num_cells=4, lDim=16,
                zmin=0.0, zmax=1.0e4, zDim=10,
                BCL={"u": "R1T0", "v": "R1T0", "w": "R1T1"},
                BCR={"u": "R1T0", "v": "R0"}, vars=("s", "u", "v", "w")),
}


def _params(pkg, case):
    kw = dict(CASES[case])
    for key, fam in (("BCL", pkg.BC), ("BCR", pkg.BC), ("BCB", pkg.ZBC),
                     ("BCT", pkg.ZBC)):
        if key in kw:
            kw[key] = {v: fam[name] for v, name in kw[key].items()}
    return pkg.GridParameters(**kw)


def _close(got, ref, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    scale = max(np.abs(ref).max(), 1e-300)
    err = np.abs(got - ref).max()
    assert err <= REL * scale, (what, err, scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_grid_transforms_match_jax(case):
    gj = jx.create_grid(_params(jx, case), jnp.float64, matmul="plain")
    gt = tx.create_grid(_params(tx, case), torch.float64, device="cpu")
    assert gt.spatial_shape == gj.spatial_shape
    assert gt.spectral_shape == gj.spectral_shape
    assert gt.field_keys == gj.field_keys
    assert np.array_equal(gt.gridpoints(), gj.gridpoints())
    for k, c in gj.coords().items():
        _close(gt.coords()[k], c, f"coords[{k}]")

    rng = np.random.default_rng(7)
    phys = rng.normal(size=(gj.nvars,) + gj.spatial_shape)
    spec_j = gj.analysis(jnp.asarray(phys))
    spec_t = gt.analysis(torch.from_numpy(phys))
    _close(spec_t, spec_j, "analysis")
    _close(gt.solve_spectral(gt.project(torch.from_numpy(phys))), spec_j,
           "project + solve_spectral")

    coeffs = rng.normal(size=gj.spectral_shape)
    fj = gj.synthesis(jnp.asarray(coeffs))
    ft = gt.synthesis(torch.from_numpy(coeffs))
    assert sorted(ft) == sorted(fj)
    for key in fj:
        _close(ft[key], fj[key], f"synthesis[{key}]")

    if case in ("RZ", "RLZ"):
        col = rng.normal(size=gj.spatial_shape)
        for name in ("column_integrate", "column_derivative",
                     "column_flux_derivative", "column_filter"):
            _close(getattr(gt, name)(torch.from_numpy(col)),
                   getattr(gj, name)(jnp.asarray(col)), name)


def test_float32_grid_on_cuda_refuses_tf32():
    """TF32 keeps a 10-bit mantissa; a float32 grid on the card must not run
    its transforms with it (the check comes before any CUDA call)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            tx.create_grid(_params(tx, "RLZ"), torch.float32, device="cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
