"""The discretely-balanced initialization on the port:
scythe_tpu_torch.balance and the balance parts of scythe_tpu_torch.examples.
jw06_baroclinic_slz against their JAX counterparts (tests/test_torch_jw06.py
holds tests/test_jw06.py's gates on the port).

Float64 on the CPU.  The example's reference column and initial fields are
array-equal to the JAX example's; the Newton solve's iterates (residual
history) within 1e-9 of the JAX solve's and its balanced state within 1e-9
of the state's max.  The solve builds its Jacobian by torch.func.jvp under
torch.func.vmap through Grid.analysis, so the analysis Function's jvp and
vmap rules run in every Newton iteration.
"""

import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

_spec = importlib.util.spec_from_file_location(
    "jw06_example_for_port",
    os.path.join(os.path.dirname(__file__), "..", "examples", "jw06_baroclinic_slz.py"),
)
jw = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jw)

from scythe_tpu import create_grid as jcreate_grid  # noqa: E402
from scythe_tpu.balance import balance_zonal_state as jbalance  # noqa: E402
from scythe_tpu.model import build_context as jbuild_context  # noqa: E402

import scythe_tpu_torch as tx  # noqa: E402
from scythe_tpu_torch import model as tmodel  # noqa: E402
from scythe_tpu_torch.balance import _total_tendency, balance_zonal_state  # noqa: E402
from scythe_tpu_torch.equations.common import get_equation_set  # noqa: E402
from scythe_tpu_torch.examples import jw06_baroclinic_slz as tw  # noqa: E402

torch.set_num_threads(2)
F64 = torch.float64


def _setup(tmp_path, cells=12, nl=32, zdim=20, ts=15.0, **kw):
    model = tw.build_model(str(tmp_path), num_cells=cells, nl=nl, zdim=zdim, ts=ts,
                           t_end=86400.0, **kw)
    grid = tx.create_grid(model.grid_params, F64, device="cpu")
    return model, grid, tmodel.build_context(model, grid, F64)


def test_example_matches_the_jax_example(tmp_path):
    """The reference column file, the initial fields (perturbed and not)
    and the diagnostics equal the JAX example's on the same grid."""
    kw = dict(num_cells=8, nl=24, zdim=12, ts=15.0, l_q=0.0)
    mj = jw.build_model(str(tmp_path / "jax"), **kw)
    mt = tw.build_model(str(tmp_path / "port"), **kw)
    with open(mj.ref_state_file) as a, open(mt.ref_state_file) as b:
        assert a.read() == b.read()
    gj = jcreate_grid(mj.grid_params, jnp.float64)
    cj = jbuild_context(mj, gj, jnp.float64)
    gt = tx.create_grid(mt.grid_params, F64, device="cpu")
    ct = tmodel.build_context(mt, gt, F64)
    for perturb in (False, True):
        pj = np.asarray(jw.initial_fields(gj, cj.ref_state, perturb=perturb))
        pt = tw.initial_fields(gt, ct.ref_state, perturb=perturb)
        np.testing.assert_array_equal(pt, pj)
    np.testing.assert_allclose(tw.diagnostics(gt, ct.ref_state, pt),
                               jw.diagnostics(gj, cj.ref_state, pj), rtol=1e-12, atol=1e-9)


@pytest.fixture(scope="module")
def balanced(tmp_path_factory):
    """The test_jw06.py:140 solve (8 cells x 24 x 12, l_q 0, nl_solve 4, 3
    iterations) in both packages."""
    tmp = tmp_path_factory.mktemp("jw06_balance")
    kw = dict(num_cells=8, nl=24, zdim=12, ts=15.0, l_q=0.0)
    mj = jw.build_model(str(tmp / "jax"), **kw)
    mt = tw.build_model(str(tmp / "port"), **kw)
    gt = tx.create_grid(mt.grid_params, F64, device="cpu")
    ct = tmodel.build_context(mt, gt, F64)
    zm = tw.initial_fields(gt, ct.ref_state, perturb=False).mean(axis=2)
    bal, info = balance_zonal_state(mt, zm, nl_solve=4, iters=3, device="cpu")
    bal_j, info_j = jbalance(mj, zm, nl_solve=4, iters=3)
    return mt, gt, ct, zm, (bal, info), (np.asarray(bal_j), info_j)


def test_balance_iterates_match_jax(balanced):
    _, _, _, zm, (bal, info), (bal_j, info_j) = balanced
    hist, hist_j = np.asarray(info["history"]), np.asarray(info_j["history"])
    assert len(hist) == len(hist_j) and info["n_unknowns"] == info_j["n_unknowns"]
    # each iterate's residual max-norm against the first's (the last, at the
    # float64 floor ~1e-14, compares to the first's scale)
    assert np.abs(hist - hist_j).max() <= 1e-9 * hist_j[0], (hist, hist_j)
    assert np.abs(bal - bal_j).max() <= 1e-9 * np.abs(bal_j).max()
    assert np.abs(bal - zm).max() > 1e-3  # the correction is not trivial


def test_balanced_init_transfers_across_nl(balanced):
    """tests/test_jw06.py::test_balanced_init_transfers_across_nl on the
    port: the nl_solve 4 correction reduces the 24-point grid's fitted
    (v, w) residual 50x."""
    model, grid, ctx, zm, (bal, info), _ = balanced
    assert info["history"][-1] < 0.02 * info["history"][0]
    eqset = get_equation_set(model.equation_set)
    vi = model.grid_params.var_index

    def resid(z):
        phys = torch.from_numpy(z)[:, :, None, :].expand(-1, -1, grid.nl, -1)
        tot = _total_tendency(eqset, grid, ctx, phys)
        return torch.stack([tot[vi("v")].mean(dim=1), tot[vi("w")].mean(dim=1)]).numpy()

    assert np.abs(resid(bal)).max() < 0.02 * np.abs(resid(zm)).max()


def test_on_cpu_means_the_cpu(tmp_path, monkeypatch):
    """A JAX-style call with on_cpu=True runs on the CPU even where the
    default device (the card) is missing; without it the default raises."""
    model, grid, ctx = _setup(tmp_path / "a", cells=4, nl=8, zdim=8, l_q=0.0)
    zm = tw.initial_fields(grid, ctx.ref_state, perturb=False).mean(axis=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        balance_zonal_state(model, zm, iters=1)
    _, info = balance_zonal_state(model, zm, iters=1, on_cpu=True)
    assert info["history"][-1] < info["history"][0]


def test_balance_cache_is_keyed_on_what_enters_the_solve(tmp_path):
    """The example's cache key changes with the physics, the options, the
    time step and the state, not with nl (the solve replaces it); a second
    call loads the stored correction."""
    model, grid, ctx = _setup(tmp_path / "b", cells=4, nl=8, zdim=8, l_q=0.0)
    zm = tw.initial_fields(grid, ctx.ref_state, perturb=False).mean(axis=2)
    key = tw.balance_key(model, zm, nl_solve=4, iters=3)
    assert tw.balance_key(model, zm, nl_solve=4, iters=3) == key
    assert tw.balance_key(model.with_(grid_params=model.grid_params.__class__(
        **{**model.grid_params.__dict__, "lDim": 16})), zm, nl_solve=4, iters=3) == key
    for other in (model.with_(ts=10.0),
                  model.with_(physical_params={**model.phys(), "K": 2.0e5}),
                  model.with_(options={**model.opts(), "si_scale": 2.0})):
        assert tw.balance_key(other, zm, nl_solve=4, iters=3) != key
    assert tw.balance_key(model, zm + 1e-9, nl_solve=4, iters=3) != key
    assert tw.balance_key(model, zm, nl_solve=4, iters=2) != key
    d1, h1 = tw.balanced_delta(model, grid, ctx, cache_dir=str(tmp_path), device="cpu",
                               iters=1)
    d2, h2 = tw.balanced_delta(model, grid, ctx, cache_dir=str(tmp_path), device="cpu",
                               iters=1)
    assert h1 is not None and h2 is None
    np.testing.assert_array_equal(d1, d2)
