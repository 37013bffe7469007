"""4D-Var on the port: scythe_tpu_torch.examples.assimilate_4dvar against
the JAX example's functions, and the outcome gates of tests/test_4dvar.py
on the port (tests/test_torch_enkf.py holds the ensemble smoother's).

Float64 on the CPU, the two-layer TC twin experiment at 32 cells x 32.
4D-Var: the cost's gradient at the background against jax.grad, and the
first Adam iterate against the JAX example's.  The background is
axisymmetric with ub = 0, so the diagnosed boundary-layer w is round-off
there and w_ = |w|/2 - w takes each package's own round-off sign: the
gradients of the boundary-layer winds ub, vb part by up to ~6e-6 of their
max (bound 1e-4), h, ug and vg agree within 1e-9.  Adam's first step
normalizes each component (lr g / (|g| + eps)), so its iterate is held on
h, ug and vg, within 1e-6 (the step amplifies a gradient's error by up
to lr / eps), and the update rule on a shared gradient sequence at 1e-12.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_example_for_port",
        os.path.join(os.path.dirname(__file__), "..", "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


fdv_j = _load("assimilate_4dvar")

from scythe_tpu_torch.examples import assimilate_4dvar as fdv  # noqa: E402

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def jax_case():
    model, grid, sims, truth0, bg = fdv_j.build_case()
    return grid, sims, truth0, bg, fdv_j.synthesize_obs(sims, truth0)


@pytest.fixture(scope="module")
def port_case():
    model, grid, sims, truth0, bg = fdv.build_case(device="cpu", remat=False)
    return grid, sims, truth0, bg, fdv.synthesize_obs(sims, truth0)


def test_4dvar_case_matches_jax(jax_case, port_case):
    """Truth, background and the noisy observations (numpy noise, the same
    draws) agree with the JAX example's."""
    _, _, tj, bj, oj = jax_case
    _, _, tt, bt, ot = port_case
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    assert _rel(bt.numpy(), bj) <= 1e-14
    for n in fdv.OBS_STEPS:
        assert _rel(ot[n].numpy(), oj[n]) <= 1e-12, n


def test_4dvar_gradient_and_first_iterate_match_jax(jax_case, port_case):
    gj, sj, _, bj, oj = jax_case
    gt, st, _, bt, ot = port_case
    k = fdv.wavenumber_weights(gt, torch.float64, "cpu").numpy()

    def cost_j(d):
        x0 = bj + gj.synthesis(d)["val"]
        J = sum(0.5 * jnp.sum((sj[n]({}, x0)[fdv.OBS_VAR][fdv.SUBSAMPLE] - oj[n]) ** 2)
                / fdv.OBS_SIGMA**2 for n in fdv.OBS_STEPS)
        return J + 0.5 * jnp.sum(k * d**2) * 1e-2

    g_jax = np.asarray(jax.grad(cost_j)(jnp.zeros(gj.spectral_shape)))
    cost, _ = fdv.cost_fn(gt, st, bt, ot)
    d = torch.zeros(gt.spectral_shape, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(cost(d), d)
    g = g.numpy()
    for v in (0, 1, 2):  # h, ug, vg
        assert np.abs(g[v] - g_jax[v]).max() <= 1e-9 * np.abs(g_jax[v]).max(), v
    for v in (3, 4):  # ub, vb: through |w| at w = round-off
        assert np.abs(g[v] - g_jax[v]).max() <= 1e-4 * np.abs(g_jax[v]).max(), v
    x1_j, _ = fdv_j.assimilate(gj, sj, bj, oj, iters=1)
    x1, _ = fdv.assimilate(gt, st, bt, ot, iters=1)
    # Adam's first step is lr g / (|g| + eps): a component's gradient error
    # dg moves it by up to lr dg / eps (3e7 dg), so the first iterate is held
    # to 1e-6 of its max (measured 1.4e-8 on ug), and the update rule
    # itself to 1e-12 below
    for v in (0, 1, 2):
        assert _rel(x1[v].numpy(), np.asarray(x1_j)[v]) <= 1e-6, v


def test_adam_and_schedule_are_optax(jax_case):
    """torch.optim.Adam with optax.adam's defaults under the port's cosine
    decay gives optax.adam(cosine_decay_schedule)'s iterates on the same
    gradient sequence (10 updates, 1e-12), as does fit_parameters' constant
    rate: the update rule of both examples and of fit_parameters."""
    import optax

    from scythe_tpu_torch.adjoint import adam, cosine_decay

    rng = np.random.default_rng(4)
    grads = [rng.normal(size=(6, 17)) * 10.0 ** rng.uniform(-12, 2, size=(6, 17))
             for _ in range(10)]
    for sched_j, sched_t in ((optax.cosine_decay_schedule(0.3, 10), cosine_decay(0.3, 10)),
                             (0.08, lambda i: 0.08)):
        opt = optax.adam(sched_j)
        xj = jnp.zeros((6, 17))
        state = opt.init(xj)
        xt = torch.zeros((6, 17), dtype=torch.float64, requires_grad=True)
        topt = adam([xt], sched_t(0))
        for i, g in enumerate(grads):
            upd, state = opt.update(jnp.asarray(g), state)
            xj = optax.apply_updates(xj, upd)
            xt.grad = torch.from_numpy(g)
            topt.param_groups[0]["lr"] = sched_t(i)
            topt.step()
            assert np.abs(xt.detach().numpy() - np.asarray(xj)).max() <= 1e-12 * 0.3, i


@pytest.fixture(scope="module")
def fourdvar_run(port_case):
    grid, sims, truth0, bg, obs = port_case
    x0, _ = fdv.assimilate(grid, sims, bg, obs, iters=150)
    return grid, sims, truth0, bg, x0


def test_4dvar_reduces_ic_error(fourdvar_run):
    _, _, truth0, bg, x0 = fourdvar_run
    v = fdv.OBS_VAR
    assert fdv.rms(x0[v], truth0[v]) < 0.65 * fdv.rms(bg[v], truth0[v])


def test_4dvar_improves_forecast(fourdvar_run):
    _, sims, truth0, bg, x0 = fourdvar_run
    v, n = fdv.OBS_VAR, fdv.OBS_STEPS[-1]
    with torch.no_grad():
        fc_tr, fc_bg, fc_an = (sims[n]({}, x)[v] for x in (truth0, bg, x0))
    assert fdv.rms(fc_an, fc_tr) < 0.6 * fdv.rms(fc_bg, fc_tr)


def test_4dvar_recovers_wave2_asymmetry(fourdvar_run):
    _, _, truth0, bg, x0 = fourdvar_run
    v = fdv.OBS_VAR
    p_tr = fdv.wave2_power(truth0[v])
    assert fdv.wave2_power(bg[v]) < 1e-20 * p_tr
    assert 0.5 * p_tr < fdv.wave2_power(x0[v]) < 2.0 * p_tr


def test_4dvar_leaves_unobserved_fields_sane(fourdvar_run):
    _, _, truth0, bg, x0 = fourdvar_run
    assert fdv.rms(x0[4], truth0[4]) < 1.2 * fdv.rms(bg[4], truth0[4])
