"""The tendency-stage probe of the port (ops.elementwise_probe) against the
JAX expression of tools/probe_pallas_elementwise.py, restated here: the tool
runs its timing script when imported.  float64 on the CPU, 1e-12 of
max|ref|.  The Triton kernel itself runs only on the card: chip_smoke.py
holds it against this plain version there."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scythe_tpu_torch import trace
from scythe_tpu_torch.ops import elementwise_probe as ep

torch.set_num_threads(2)

V, R, LZ = 9, 8, 96


def jax_expr(val, dr, drr, dl, dll, dz, dzz, rinv):
    """tools/probe_pallas_elementwise.py:30-35 (K = 10)."""
    u, v, w = val[3:4], val[4:5], val[5:6]
    adv = -u * dr - (v * rinv) * dl - w * dz
    lap = 10.0 * (drr + dr * rinv + dll * (rinv * rinv) + dzz)
    thermo = jnp.exp(val * 0.01) * jnp.log1p(val * val)
    return adv + lap + thermo


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    slots = [rng.normal(size=(V, R, LZ)) for _ in range(7)]
    rinv = (1.0 / np.linspace(100.0, 20000.0, R))[None, :, None]
    return slots + [rinv]


def test_plain_matches_jax_expression():
    args = _inputs()
    want = np.asarray(jax_expr(*map(jnp.asarray, args)))
    got = ep.probe_expr_plain(*map(torch.from_numpy, args))
    assert got.shape == (V, R, LZ)
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()


def test_wrapper_on_cpu_takes_plain_and_counts_nothing():
    args = [torch.from_numpy(a) for a in _inputs(1)]
    before = trace.process().total("elementwise_probe.launches") or 0
    got = ep.probe_expr(*args)
    assert (trace.process().total("elementwise_probe.launches") or 0) == before
    assert torch.equal(got, ep.probe_expr_plain(*args))


def test_probe_inputs_are_the_tools_shape():
    args = ep.probe_inputs("cpu", shape=(V, R, LZ))
    assert [tuple(a.shape) for a in args] == [(V, R, LZ)] * 7 + [(1, R, 1)]
    assert all(a.dtype == torch.float32 for a in args)
    assert ep.SHAPE == (9, 144, 64 * 48)
    assert float(args[7][0, 0, 0]) == pytest.approx(1.0 / 100.0)


def test_wrapper_rejects_bad_shapes():
    args = [torch.from_numpy(a) for a in _inputs(2)]
    with pytest.raises(ValueError, match="rinv"):
        ep.probe_expr(*args[:7], args[7][..., :1, :])
    with pytest.raises(ValueError, match="slot"):
        ep.probe_expr(args[0], args[1][:, :, :-1], *args[2:])
    with pytest.raises(ValueError, match="V >= 6"):
        ep.probe_expr(*(a[:5] for a in args[:7]), args[7])
