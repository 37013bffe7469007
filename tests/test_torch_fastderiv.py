"""The port's selective single-pass bf16 derivative synthesis
(``deriv_single``), mirroring tests/test_fastderiv.py: the value slot at
compensated grade, the derivative slots at bf16 grade, on RL / RZ / RLZ;
ignored outside compensated mode; off with the factored DFT.  Then the fast
grid's slots against the JAX package's fast grid on the same inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import scythe_tpu as jx
import scythe_tpu_torch as tx

torch.set_num_threads(2)


def _kw(pkg, geometry):
    kw = dict(geometry=geometry, xmin=0.0, xmax=100.0, num_cells=24, vars={"h": 1, "u": 2},
              BCL={"h": pkg.BC.R1T1})
    if geometry in ("RL", "RLZ"):
        kw["lDim"] = 32
    if geometry in ("RZ", "RLZ"):
        kw.update(zmin=0.0, zmax=10.0, zDim=16, BCB={"u": pkg.ZBC.R1T0})
    return kw


def _grids(geometry):
    kw = _kw(tx, geometry)
    gp = tx.GridParameters(**kw, deriv_single=False)
    gp_f = tx.GridParameters(**kw)  # auto -> on in compensated mode
    g64 = tx.create_grid(gp, torch.float64, matmul="plain", device="cpu")
    gc = tx.create_grid(gp, torch.float32, matmul="compensated", device="cpu")
    gf = tx.create_grid(gp_f, torch.float32, matmul="compensated", device="cpu")
    assert gf.fast and not gc.fast
    return g64, gc, gf


def _smooth_field(g64):
    c = {k: v.numpy() for k, v in g64.coords().items()}
    r = c["r"] / 100.0
    f = np.broadcast_to(np.exp(-(((r - 0.5) / 0.3) ** 2)), (1,) + g64.spatial_shape)
    out = [f[0], 0.5 - f[0]]
    if "l" in c:
        out[0] = out[0] * (1.0 + 0.3 * np.cos(2 * c["l"]))
    if "z" in c:
        out[1] = out[1] * (1.0 + 0.1 * np.sin(np.pi * c["z"] / 10.0))
    return np.stack(np.broadcast_arrays(*out))


@pytest.mark.parametrize("geometry", ["RL", "RZ", "RLZ"])
def test_fastderiv_value_exact_derivs_bf16_grade(geometry):
    g64, gc, gf = _grids(geometry)
    spec64 = g64.analysis(torch.from_numpy(np.ascontiguousarray(_smooth_field(g64))))
    spec32 = spec64.float()
    out64, outc, outf = g64.synthesis(spec64), gc.synthesis(spec32), gf.synthesis(spec32)
    # the value slot: the compensated chain's grade against comp and f64
    vscale = float(out64["val"].abs().max())
    assert float((outf["val"].double() - outc["val"].double()).abs().max()) < 3e-5 * vscale
    assert float((outf["val"].double() - out64["val"]).abs().max()) < 3e-5 * vscale
    # the derivative slots: single-pass bf16 grade (~0.4% of the chain scale)
    gscale = max(float(out64[k].abs().max()) for k in g64.field_keys)
    for key in g64.field_keys:
        if key != "val":
            err = float((outf[key].double() - out64[key]).abs().max())
            assert err < 1.5e-2 * gscale, key


def test_fastderiv_ignored_outside_compensated_mode():
    gp = tx.GridParameters(geometry="RL", xmin=0.0, xmax=100.0, num_cells=8, lDim=16,
                           vars=("h",), deriv_single=True)
    g = tx.create_grid(gp, torch.float64, matmul="plain", device="cpu")
    assert not g.fast and g.l_deriv_f is None


def test_fastderiv_disabled_with_factored_dft():
    gp = tx.GridParameters(geometry="RL", xmin=0.0, xmax=100.0, num_cells=8, lDim=16,
                           vars=("h",), deriv_single=True, l_factored=True)
    g = tx.create_grid(gp, torch.float32, matmul="compensated", device="cpu")
    assert not g.fast
    # and the factored path still synthesizes all slots
    f = torch.from_numpy(np.random.default_rng(0).normal(size=(1,) + g.spatial_shape)).float()
    out = g.synthesis(g.analysis(f))
    assert set(out) == set(g.field_keys)


def test_fastderiv_off_on_r_grids():
    """R grids have no derivative GEMM to relax: fast stays off, as in JAX."""
    gp = tx.GridParameters(geometry="R", xmin=0.0, xmax=100.0, num_cells=8, vars=("h",))
    g = tx.create_grid(gp, torch.float32, matmul="compensated", device="cpu")
    assert g.comp and not g.fast


@pytest.mark.parametrize("geometry", ["RL", "RZ", "RLZ"])
def test_fast_grid_matches_jax(geometry):
    """The fast grid's slots against the JAX package's fast grid on the same
    f32 spectral input: the value slot within 3e-5 of its max, each
    derivative slot within 1e-2 of its max (a single bf16 pass: an f32-sized
    difference in its input moves a rounding by a bf16 step)."""
    gj = jx.create_grid(jx.GridParameters(**_kw(jx, geometry)), jnp.float32,
                        matmul="compensated")
    g64, _, gf = _grids(geometry)
    assert gj.fast and gf.fast
    spec = g64.analysis(torch.from_numpy(np.ascontiguousarray(_smooth_field(g64)))).float()
    oj, ot = gj.synthesis(jnp.asarray(spec.numpy())), gf.synthesis(spec)
    for key in gf.field_keys:
        ref = np.asarray(oj[key], np.float64)
        for v in range(ref.shape[0]):
            scale = np.abs(ref[v]).max()
            err = np.abs(ot[key][v].double().numpy() - ref[v]).max()
            assert err <= (3e-5 if key == "val" else 1e-2) * scale, (key, v, err / scale)
