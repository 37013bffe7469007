"""The derived diagnostics of scythe_tpu_torch against scythe_tpu's: the
cylindrical operators on the synthesized fields of a seeded random RL state
(float64 on the CPU, 1e-12 of max|ref|), on an analytic solid-body rotation,
and the potential-intensity diagnostic on a sounding column (1e-12).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scythe_tpu as jx
from scythe_tpu import diagnostics as jdiag

import scythe_tpu_torch as tx
from scythe_tpu_torch import diagnostics as tdiag

torch.set_num_threads(2)


def _gp(pkg):
    return pkg.GridParameters(
        geometry="RL", xmin=0.0, xmax=1.0e5, num_cells=10, lDim=16,
        BCL={"h": pkg.BC.R1T1, "u": pkg.BC.R1T0, "v": pkg.BC.R1T0},
        vars=("h", "u", "v"),
    )


@pytest.fixture(scope="module")
def fields():
    gj = jx.create_grid(_gp(jx), jnp.float64)
    gt = tx.create_grid(_gp(tx), torch.float64, device="cpu")
    spec = np.random.default_rng(3).normal(size=gt.spectral_shape)
    return (gj.synthesis(jnp.asarray(spec)), gj.coords()["r"],
            gt.synthesis(torch.from_numpy(spec)), gt.coords()["r"], gt)


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("name", ["relative_vorticity", "divergence", "okubo_weiss"])
def test_cylindrical_operators_match(fields, name):
    fj, rj, ft, rt, _ = fields
    _close(getattr(tdiag, name)(ft, rt, 1, 2), getattr(jdiag, name)(fj, rj, 1, 2))


def test_kinetic_energy_matches(fields):
    fj, _, ft, _, _ = fields
    _close(tdiag.kinetic_energy(ft, 1, 2), jdiag.kinetic_energy(fj, 1, 2))


def test_solid_body_rotation(fields):
    """v = omega r, u = 0: vorticity 2 omega, no divergence, OW = -4 omega^2,
    away from the outer boundary's constraint."""
    gt = fields[4]
    omega = 1.0e-3
    r = gt.coords()["r"]
    phys = torch.zeros((3,) + gt.spatial_shape, dtype=torch.float64)
    phys[2] = omega * r
    f = gt.synthesis(gt.analysis(phys))
    inner = slice(3, 15)
    zeta = tdiag.relative_vorticity(f, r, 1, 2)[inner]
    assert float((zeta - 2 * omega).abs().max()) < 1e-6 * omega
    assert float(tdiag.divergence(f, r, 1, 2)[inner].abs().max()) < 1e-6 * omega
    ow = tdiag.okubo_weiss(f, r, 1, 2)[inner]
    assert float((ow + 4 * omega**2).abs().max()) < 1e-5 * omega**2
    ke = tdiag.kinetic_energy(f, 1, 2)[inner]
    assert torch.allclose(ke, 0.5 * (omega * r[inner]) ** 2 * torch.ones_like(ke), rtol=1e-6)


@pytest.mark.parametrize("sst", [299.0, 302.15])
def test_emanuel_potential_intensity_matches(sst):
    z = np.linspace(0.0, 16000.0, 30)
    Tk = np.maximum(300.0 - 6.5e-3 * z, 200.0)
    p = 1015.0 * np.exp(-z / 7500.0)
    q = 0.018 * np.exp(-z / 2500.0)
    ref = jdiag.emanuel_potential_intensity(Tk, p, q, sst)
    got = tdiag.emanuel_potential_intensity(Tk, p, q, sst)
    assert all(isinstance(x, float) for x in got)
    assert got == pytest.approx(ref, rel=1e-12)
    assert got[0] > 30.0 and got[1] == 200.0
