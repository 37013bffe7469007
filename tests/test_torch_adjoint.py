"""Differentiation through the port: the kernels' autograd Functions and
scythe_tpu_torch.adjoint against jax.grad.

Both kernels are torch.autograd.Functions whose rules (backward, jvp, vmap)
run the same way on both devices; on the CPU their forward is the plain
version, so gradcheck and torch.func here check the formulas the card uses.
Then the five tests of tests/test_adjoint.py and tests/test_jax_native.py's
gradient and vmap tests on the port, each gradient also within 1e-9
(relative) of jax.grad on the same numpy inputs, and a gradient through
both kernels' paths (the moist RLZ semi-implicit step) against jax.grad.
Float64 on the CPU throughout.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import scythe_tpu as jx
from scythe_tpu import timeintegration as jti
from scythe_tpu.adjoint import fit_parameters as jfit
from scythe_tpu.adjoint import make_simulator as jsim
from scythe_tpu.model import build_context as jbuild_context
from scythe_tpu.model import build_step as jbuild_step

import scythe_tpu_torch as tx
from scythe_tpu_torch import model as tmodel
from scythe_tpu_torch import timeintegration as tti
from scythe_tpu_torch.adjoint import fit_parameters as tfit
from scythe_tpu_torch.adjoint import make_simulator as tsim
from scythe_tpu_torch.ops import column_solve, rlz_analysis

torch.set_num_threads(2)
F64 = torch.float64


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# ---- the kernels' Functions -------------------------------------------


@pytest.fixture(scope="module")
def stage_op():
    return tti.build_semiimplicit_ops(12, 0.0, 1.0e4, None, 9.0e4, 0.2, F64, "cpu").solve


@pytest.fixture(scope="module")
def analysis_ops():
    gp = tx.GridParameters(geometry="SLZ", xmin=-np.pi / 2, xmax=np.pi / 2, num_cells=4,
                           lDim=8, sphere_radius=6.37122e6, zmin=0.0, zmax=1.5e4, zDim=6,
                           vars={"a": 1, "b": 2})
    g = tx.create_grid(gp, F64, device="cpu")
    return g, (g.l_analysis, g.ring_mask, g.analysis_r, g.analysis_z)


def _cols(seed, *shape):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=shape)) for _ in range(2))


def test_column_solve_gradcheck(stage_op):
    x, w = _cols(0, 7, 12)
    x.requires_grad_(True)
    w.requires_grad_(True)
    fn = lambda a, b: column_solve.apply_column_operator(a, b, stage_op)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (x, w))
    assert torch.autograd.gradgradcheck(fn, (x, w))


def test_column_solve_backward_is_the_transpose(stage_op):
    """The backward applies M^T: <M u, g> = <u, M^T g> to 1e-13, and its
    output carries the Function's grad_fn."""
    x, w = _cols(1, 9, 12)
    gw, gx = _cols(2, 9, 12)
    x.requires_grad_(True)
    w.requires_grad_(True)
    out = column_solve.apply_column_operator(x, w, stage_op)
    assert type(out[0].grad_fn).__name__ == "ColumnSolveFnBackward"
    ga, gb = torch.autograd.grad(out, (x, w), (gw, gx))
    lhs = float((out[0] * gw).sum() + (out[1] * gx).sum())
    rhs = float((x * ga).sum() + (w * gb).sum())
    assert abs(lhs - rhs) <= 1e-13 * abs(lhs)
    ref = torch.cat([gw, gx], dim=1) @ stage_op.M
    assert torch.allclose(torch.cat([ga, gb], dim=1), ref, rtol=0, atol=1e-13 * float(ref.abs().max()))


def test_column_solve_jvp_and_vmap(stage_op):
    fn = lambda a, b: column_solve.apply_column_operator(a, b, stage_op)  # noqa: E731
    x, w = _cols(3, 5, 12)
    xt, wt = _cols(4, 5, 12)
    _, tang = torch.func.jvp(fn, (x, w), (xt, wt))
    for a, b in zip(tang, fn(xt, wt)):
        assert torch.equal(a, b)  # linear: the tangent is the same map
    xb, wb = _cols(5, 3, 5, 12)
    out = torch.func.vmap(fn)(xb, wb)
    shared = torch.func.vmap(fn, in_dims=(0, None))(xb, wb[0])
    for i in range(3):
        for a, b in zip((out[0][i], out[1][i]), fn(xb[i], wb[i])):
            assert float((a - b).abs().max()) <= 1e-14 * float(b.abs().max())
        assert float((shared[0][i] - fn(xb[i], wb[0])[0]).abs().max()) <= 1e-13
    jac = torch.func.jacfwd(lambda a: fn(a, w)[0])(x)
    assert jac.shape == (5, 12, 5, 12)


def test_fused_column_solve_differentiates_on_the_cpu():
    """The TPU function's counterpart: its plain chain on the CPU carries a
    graph too (gradcheck through the five operators' chain)."""
    o = tti.build_semiimplicit_ops(8, 0.0, 1.0e4, None, 9.0e4, 0.2, F64, "cpu")
    x, w = _cols(6, 4, 8)
    x.requires_grad_(True)
    ops = (o.col_filter, o.col_deriv, o.hinv, o.synth, o.dsynth)
    assert torch.autograd.gradcheck(
        lambda a: column_solve.fused_column_solve(a, w, *ops, 0.25, 9.0e4, mode="plain"),
        (x,))


def test_analysis_gradcheck_jvp_vmap(analysis_ops):
    g, ops = analysis_ops
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(2,) + g.spatial_shape)).requires_grad_(True)
    fn = lambda p: rlz_analysis.rlz_analysis(p, *ops)  # noqa: E731
    out = fn(x)
    assert type(out.grad_fn).__name__ == "RLZAnalysisFnBackward"
    assert torch.autograd.gradcheck(fn, (x,))
    t = torch.from_numpy(rng.normal(size=x.shape))
    _, tang = torch.func.jvp(fn, (x.detach(),), (t,))
    assert torch.equal(tang, fn(t))
    xb = torch.from_numpy(rng.normal(size=(3,) + tuple(x.shape)))
    outb = torch.func.vmap(fn)(xb)
    for i in range(3):
        assert float((outb[i] - fn(xb[i])).abs().max()) <= 1e-14 * float(outb[i].abs().max())
    # the transposed chain is the adjoint: <A x, y> = <x, A^T y>
    y = torch.from_numpy(rng.normal(size=tuple(out.shape)))
    lhs = float((fn(t) * y).sum())
    rhs = float((t * rlz_analysis.rlz_analysis_transposed(y, *ops)).sum())
    assert abs(lhs - rhs) <= 1e-13 * abs(lhs)


def test_analysis_vmap_folds_members_into_variables(analysis_ops, monkeypatch):
    """One call of the plain version (on the card: one launch) for every
    member, at [members x V, ...]."""
    g, ops = analysis_ops
    seen = []
    plain = rlz_analysis.rlz_analysis_plain

    def spy(phys, *a):
        seen.append(tuple(phys.shape))
        return plain(phys, *a)

    monkeypatch.setattr(rlz_analysis, "rlz_analysis_plain", spy)
    xb = torch.zeros((5, 2) + g.spatial_shape, dtype=F64)
    torch.func.vmap(lambda p: rlz_analysis.rlz_analysis(p, *ops))(xb)
    assert seen == [(10,) + g.spatial_shape]


# ---- tests/test_adjoint.py on the port, against jax.grad ---------------


def _advection_model(pkg, tmp_path, n_cells=30):
    gp = pkg.GridParameters(
        geometry="R", xmin=-50.0, xmax=50.0, num_cells=n_cells,
        BCL={"u": pkg.BC.PERIODIC}, BCR={"u": pkg.BC.PERIODIC}, vars={"u": 1},
    )
    return pkg.ModelParameters(
        ts=0.05, integration_time=5.0, output_interval=5.0,
        equation_set="LinearAdvection1D",
        initial_conditions=str(tmp_path / "unused.csv"), output_dir=str(tmp_path / "out"),
        grid_params=gp, physical_params={"c_0": 1.0, "K": 0.05},
    )


def _c0_grads(tmp_path, n_cells, n_steps=None):
    """(port AD, port FD, jax.grad) of the c_0 misfit through n_steps."""
    simj, gj, _ = jsim(_advection_model(jx, tmp_path, n_cells), jnp.float64, n_steps=n_steps)
    simt, _, _ = tsim(_advection_model(tx, tmp_path, n_cells), F64, n_steps=n_steps,
                      device="cpu")
    r = gj.gridpoints()[:, 0]
    phys0 = np.exp(-((r / 15.0) ** 2))[None, :]
    target = np.asarray(simj({"c_0": jnp.asarray(1.3)}, phys0))
    tgt = torch.from_numpy(target)

    def loss(c0):
        return torch.mean((simt({"c_0": c0}, phys0) - tgt) ** 2)

    c = torch.tensor(1.0, dtype=F64, requires_grad=True)
    (g_ad,) = torch.autograd.grad(loss(c), c)
    eps = 1e-5
    with torch.no_grad():
        g_fd = float((loss(torch.tensor(1.0 + eps, dtype=F64))
                      - loss(torch.tensor(1.0 - eps, dtype=F64))) / (2 * eps))
    g_jax = float(jax.grad(lambda c0: jnp.mean((simj({"c_0": c0}, phys0) - target) ** 2))(
        jnp.asarray(1.0)))
    return float(g_ad), g_fd, g_jax


def test_grad_matches_finite_difference(tmp_path):
    g_ad, g_fd, g_jax = _c0_grads(tmp_path, 30)
    assert abs(g_ad - g_fd) <= 1e-6 + 1e-5 * abs(g_fd), (g_ad, g_fd)
    assert g_ad < 0.0
    assert abs(g_ad - g_jax) <= 1e-9 * abs(g_jax), (g_ad, g_jax)


def test_chunked_scan_gradient(tmp_path):
    """500 steps: the JAX package scans them in bounded chunks, the port in
    a plain loop; the gradients agree and match finite differences."""
    g_ad, g_fd, g_jax = _c0_grads(tmp_path, 20, n_steps=500)
    assert abs(g_ad - g_fd) <= 1e-6 + 1e-5 * abs(g_fd), (g_ad, g_fd)
    assert abs(g_ad - g_jax) <= 1e-9 * abs(g_jax), (g_ad, g_jax)


def test_radiation_speed_baked_static(tmp_path):
    def model(pkg):
        gp = pkg.GridParameters(
            geometry="R", xmin=0.0, xmax=1.0e5, num_cells=24,
            BCL={"h": pkg.BC.R1T1, "u": pkg.BC.R1T0}, BCR={"h": pkg.BC.R0, "u": pkg.BC.R0},
            vars={"h": 1, "u": 2},
        )
        return pkg.ModelParameters(
            ts=2.0, integration_time=40.0, output_interval=40.0,
            equation_set="LinearShallowWater1D",
            initial_conditions=str(tmp_path / "unused.csv"), output_dir=str(tmp_path / "out"),
            grid_params=gp, physical_params={"g": 9.81, "H": 1000.0, "K": 0.0},
            options={"radiation_width": 2.0e4},
        )

    simj, gj, _ = jsim(model(jx), jnp.float64)
    simt, _, _ = tsim(model(tx), F64, device="cpu")
    r = gj.gridpoints()[:, 0]
    phys0 = np.stack([np.exp(-(((r - 3e4) / 8e3) ** 2)), np.zeros_like(r)])
    g = torch.tensor(9.81, dtype=F64, requires_grad=True)
    (gt,) = torch.autograd.grad(torch.sum(simt({"g": g}, phys0) ** 2), g)
    gj_ = float(jax.grad(lambda g_: jnp.sum(simj({"g": g_}, phys0) ** 2))(jnp.asarray(9.81)))
    assert np.isfinite(float(gt))
    assert abs(float(gt) - gj_) <= 1e-9 * abs(gj_), (float(gt), gj_)


def test_grad_wrt_initial_conditions(tmp_path):
    simj, gj, _ = jsim(_advection_model(jx, tmp_path, 20), jnp.float64, n_steps=40)
    simt, _, _ = tsim(_advection_model(tx, tmp_path, 20), F64, n_steps=40, device="cpu")
    r = gj.gridpoints()[:, 0]
    phys0 = np.exp(-((r / 15.0) ** 2))[None, :]
    target = np.asarray(simj({}, 0.9 * phys0))
    tgt = torch.from_numpy(target)

    def loss(p0):
        return torch.mean((simt({}, p0) - tgt) ** 2)

    p0 = torch.from_numpy(phys0.copy()).requires_grad_(True)
    (g,) = torch.autograd.grad(loss(p0), p0)
    assert g.shape == p0.shape and torch.isfinite(g).all()
    d = torch.from_numpy(np.random.default_rng(0).standard_normal(phys0.shape))
    eps = 1e-6
    with torch.no_grad():
        fd = float((loss(p0 + eps * d) - loss(p0 - eps * d)) / (2 * eps))
    ad = float((g * d).sum())
    assert abs(ad - fd) <= 1e-9 + 1e-5 * abs(fd), (ad, fd)
    g_jax = np.asarray(jax.grad(lambda p: jnp.mean((simj({}, p) - target) ** 2))(
        jnp.asarray(phys0)))
    assert _rel(g.numpy(), g_jax) <= 1e-9


def test_recover_drag_coefficient(tmp_path):
    """fit_parameters (Adam with optax.adam's defaults, log space) recovers
    Cd in 60 iterations, and its losses and result agree with the JAX
    package's (1e-9 relative)."""

    def model(pkg):
        gp = pkg.GridParameters(
            geometry="R", xmin=0.0, xmax=2.0e5, num_cells=20,
            BCL={"vgr": pkg.BC.R1T0, "u": pkg.BC.R1T0, "v": pkg.BC.R1T0, "w": pkg.BC.R1T1},
            BCR={"vgr": pkg.BC.R0, "u": pkg.BC.R1T1, "v": pkg.BC.R0, "w": pkg.BC.R0},
            vars={"vgr": 1, "u": 2, "v": 3, "w": 4},
        )
        return pkg.ModelParameters(
            ts=5.0, integration_time=300.0, output_interval=300.0,
            equation_set="Williams2013_slabTCBL",
            initial_conditions=str(tmp_path / "unused.csv"), output_dir=str(tmp_path / "out"),
            grid_params=gp,
            physical_params={"K": 1500.0, "Cd": 2.4e-3, "h": 1000.0, "f": 5.0e-5},
        )

    simj, gj, _ = jsim(model(jx), jnp.float64)
    simt, _, _ = tsim(model(tx), F64, device="cpu")
    r = gj.gridpoints()[:, 0]
    rm, vm = 5.0e4, 30.0
    vgr = np.where(r < rm, vm * r / rm, vm * rm / r)
    phys0 = np.stack([vgr, np.zeros_like(r), vgr, np.zeros_like(r)])
    obs = np.asarray(simj({"Cd": jnp.asarray(2.4e-3)}, phys0))[1:3]
    fitted, history = tfit(simt, {"Cd": 1.0e-3}, phys0, obs, steps=60, learning_rate=0.08,
                           obs_slice=np.s_[1:3])
    assert history[-1] < 1e-6 * (1 + history[0]), history[-1]
    assert abs(fitted["Cd"] - 2.4e-3) / 2.4e-3 < 0.05, fitted
    fj, hj = jfit(simj, {"Cd": 1.0e-3}, phys0, obs, steps=60, learning_rate=0.08,
                  obs_slice=np.s_[1:3])
    assert abs(fitted["Cd"] - fj["Cd"]) <= 1e-9 * fj["Cd"], (fitted, fj)
    assert _rel(history[:10], hj[:10]) <= 1e-9


# ---- tests/test_jax_native.py:54-93 on the port -------------------------


def _native(pkg, mod, device_kw):
    gp = pkg.GridParameters(geometry="R", xmin=-50.0, xmax=50.0, num_cells=40,
                            BCL={"u": pkg.BC.PERIODIC}, BCR={"u": pkg.BC.PERIODIC},
                            vars={"u": 1})
    model = pkg.ModelParameters(ts=0.1, integration_time=1.0, output_interval=1.0,
                                equation_set="LinearAdvection1D", grid_params=gp,
                                physical_params={"c_0": 1.0, "K": 0.05})
    dt = jnp.float64 if pkg is jx else F64
    grid = pkg.create_grid(gp, dt, **device_kw)
    ctx = mod.build_context(model, grid, dt)
    return grid, mod.build_step(model, grid, ctx, dt)


def _rollout_t(step, grid, u0, n):
    state = tti.initial_state(grid.analysis(u0[None, :]), (1,) + grid.spatial_shape, F64)
    return grid.synthesis(tmodel.make_scan(step, n)(state).spec)["val"][0]


def _rollout_j(step, grid, u0, n):
    state = jti.initial_state(grid.analysis(u0[None, :]), (1,) + grid.spatial_shape,
                              jnp.float64)
    out, _ = jax.lax.scan(lambda s, _: (step(s), None), state, None, length=n)
    return grid.synthesis(out.spec)["val"][0]


class _JModel:
    build_context = staticmethod(jbuild_context)
    build_step = staticmethod(jbuild_step)


def test_gradient_through_time_loop():
    gt, st = _native(tx, tmodel, {"device": "cpu"})
    gj, sj = _native(jx, _JModel, {})
    r = np.asarray(gt.r_mish)
    target = np.exp(-(((r - 5.0) / 15.0) ** 2))
    u0 = np.exp(-((r / 15.0) ** 2))

    def loss(u):
        return torch.mean((_rollout_t(st, gt, u, 20) - torch.from_numpy(target)) ** 2)

    u = torch.from_numpy(u0.copy()).requires_grad_(True)
    (g,) = torch.autograd.grad(loss(u), u)
    assert torch.isfinite(g).all()
    v = np.random.default_rng(0).normal(size=u0.shape)
    v = torch.from_numpy(v / np.linalg.norm(v))
    eps = 1e-6
    with torch.no_grad():
        fd = float((loss(u + eps * v) - loss(u - eps * v)) / (2 * eps))
        ad = float((g * v).sum())
        assert np.isclose(fd, ad, rtol=1e-6), (fd, ad)
        assert float(loss(u - 0.1 * g / g.norm())) < float(loss(u))
    g_jax = jax.grad(lambda w: jnp.mean((_rollout_j(sj, gj, w, 20) - target) ** 2))(
        jnp.asarray(u0))
    assert _rel(g.numpy(), g_jax) <= 1e-9


def test_vmapped_ensemble():
    gt, st = _native(tx, tmodel, {"device": "cpu"})
    gj, sj = _native(jx, _JModel, {})
    r = np.asarray(gt.r_mish)
    shifts = np.array([-10.0, 0.0, 5.0, 12.0])
    u0s = np.exp(-(((r[None, :] - shifts[:, None]) / 15.0) ** 2))
    out = torch.func.vmap(lambda u: _rollout_t(st, gt, u, 10))(torch.from_numpy(u0s))
    assert out.shape == (4,) + gt.spatial_shape
    single = _rollout_t(st, gt, torch.from_numpy(u0s[2]), 10)
    np.testing.assert_allclose(out[2].numpy(), single.numpy(), atol=1e-13)
    ref = np.asarray(jax.vmap(lambda u: _rollout_j(sj, gj, u, 10))(jnp.asarray(u0s)))
    assert _rel(out.numpy(), ref) <= 1e-12


# ---- gradients through both kernels' paths ----------------------------


def _sounding(tmp_path):
    snd = tmp_path / "snd.txt"
    zs = np.linspace(0.0, 12000.0, 40)
    with open(snd, "w") as f:
        f.write("1015.0 300.0 14.0\n")
        for z in zs[1:]:
            f.write(f"{z} {300.0 + 0.004 * z} {14.0 * np.exp(-z / 2500.0)}\n")
    return str(snd)


def _kernel_path_model(pkg, tmp_path, which):
    """Euler_test on RZ, semi-implicit (every step's column solve),
    LinearAdvectionRLZ on RLZ (every step's closing analysis), or the moist
    RLZ core, semi-implicit (both, and the condensation adjustment)."""
    if which == "moist":
        gp = pkg.GridParameters(
            geometry="RLZ", xmin=0.0, xmax=10000.0, num_cells=4, lDim=8, zmin=0.0,
            zmax=10000.0, zDim=12, BCL={"u": pkg.BC.R1T0, "v": pkg.BC.R1T0, "w": pkg.BC.R1T1},
            BCR={"u": pkg.BC.R1T0, "v": pkg.BC.R0},
            vars=("s", "xi", "mu", "u", "v", "w", "mu_c", "mu_r", "qss"))
        return pkg.ModelParameters(
            ts=0.25, integration_time=2.0, output_interval=2.0, equation_set="MoistEulerRLZ",
            initial_conditions=str(tmp_path / "unused.csv"), output_dir=str(tmp_path / "out"),
            ref_state_file=_sounding(tmp_path), grid_params=gp,
            physical_params={"K": 10.0, "f": 5.0e-4}, options={"semiimplicit": True})
    if which == "column-solve":
        gp = pkg.GridParameters(
            geometry="RZ", xmin=0.0, xmax=10000.0, num_cells=6, zmin=0.0, zmax=10000.0,
            zDim=12, BCL={"u": pkg.BC.R1T0, "w": pkg.BC.R1T1}, BCR={"u": pkg.BC.R1T0},
            vars=("s", "xi", "mu", "u", "w"))
        return pkg.ModelParameters(
            ts=0.2, integration_time=2.0, output_interval=2.0, equation_set="Euler_test",
            initial_conditions=str(tmp_path / "unused.csv"), output_dir=str(tmp_path / "out"),
            ref_state_file=_sounding(tmp_path), grid_params=gp, physical_params={"K": 5.0},
            options={"semiimplicit": True})
    gp = pkg.GridParameters(
        geometry="RLZ", xmin=0.0, xmax=10000.0, num_cells=4, lDim=8, zmin=0.0,
        zmax=10000.0, zDim=8, vars={"h": 1, "u": 2, "v": 3})
    return pkg.ModelParameters(
        ts=0.5, integration_time=5.0, output_interval=5.0, equation_set="LinearAdvectionRLZ",
        initial_conditions=str(tmp_path / "unused.csv"), output_dir=str(tmp_path / "out"),
        grid_params=gp, physical_params={"K": 50.0})


@pytest.mark.parametrize("which", ["column-solve", "analysis", "moist"])
def test_gradient_through_the_kernels_paths_matches_jax(tmp_path, which):
    """8-10 steps through ColumnSolveFn (Euler_test, semi-implicit),
    RLZAnalysisFn (LinearAdvectionRLZ) or both (MoistEulerRLZ): the gradient
    of a weighted sum of the final fields with respect to phys0 and to a
    parameter (K; the moist core's Coriolis f, which the JAX package can
    trace there) agrees with jax.grad within 1e-9 of its max, and the
    parameter's with a central difference (1e-5).  The moist case carries
    cloud and rain everywhere (at exactly zero condensate the warm-rain
    terms' derivatives are not finite, in both packages alike); it pins the
    condensation adjustment's out-of-place update, whose earlier in-place
    write corrupted the saved tensors of its backward (2% of the phys0
    gradient after 8 steps under checkpoint)."""
    simj, gj, _ = jsim(_kernel_path_model(jx, tmp_path, which), jnp.float64)
    simt, gt, _ = tsim(_kernel_path_model(tx, tmp_path, which), F64, device="cpu")
    rng = np.random.default_rng(11)
    pts = gt.gridpoints()
    r, z = pts[:, 0], pts[:, -1]
    bump = np.exp(-(((r - 5000.0) / 2000.0) ** 2 + ((z - 3000.0) / 2000.0) ** 2))
    phys0 = np.zeros((gt.nvars,) + gt.spatial_shape)
    phys0[0] = (2.0 * bump).reshape(gt.spatial_shape)
    if which == "analysis":
        phys0[1], phys0[2] = 5.0, 10.0  # the advecting wind
    if which == "moist":
        phys0[6] = phys0[7] = 1.0e-4  # cloud and rain everywhere
    wts = rng.normal(size=phys0.shape)
    param, p_val = {"column-solve": ("K", 5.0), "analysis": ("K", 50.0),
                    "moist": ("f", 5.0e-4)}[which]

    def loss_t(p0, v):
        return torch.sum(torch.from_numpy(wts) * simt({param: v}, p0))

    p0 = torch.from_numpy(phys0.copy()).requires_grad_(True)
    pv = torch.tensor(p_val, dtype=F64, requires_grad=True)
    gp0, gpv = torch.autograd.grad(loss_t(p0, pv), (p0, pv))
    jp0, jpv = jax.grad(lambda p, v: jnp.sum(wts * simj({param: v}, p)), argnums=(0, 1))(
        jnp.asarray(phys0), jnp.asarray(p_val))
    assert _rel(gp0.numpy(), jp0) <= 1e-9
    assert abs(float(gpv) - float(jpv)) <= 1e-9 * abs(float(jpv)), (float(gpv), float(jpv))
    eps = 1e-2 * p_val
    with torch.no_grad():
        fd = float((loss_t(p0, p_val + eps) - loss_t(p0, p_val - eps)) / (2 * eps))
    assert abs(float(gpv) - fd) <= 1e-5 * abs(fd), (float(gpv), fd)


def test_moist_set_keeps_k_traced(tmp_path):
    """K reaches MoistEulerRLZ's vertical diffusivity through the K_v
    default (equations/common.py same_param): it stays a tensor, where the
    JAX package takes float(K) and cannot trace it.  One tendency is affine
    in K: its gradient against a central difference over +-1 (1e-6; a small
    step drowns in the round-off of the O(5e4) sum)."""
    model = _kernel_path_model(tx, tmp_path, "column-solve")
    gp = tx.GridParameters(
        geometry="RLZ", xmin=0.0, xmax=10000.0, num_cells=4, lDim=8, zmin=0.0,
        zmax=10000.0, zDim=12, BCL={"u": tx.BC.R1T0, "v": tx.BC.R1T0, "w": tx.BC.R1T1},
        BCR={"u": tx.BC.R1T0, "v": tx.BC.R0},
        vars=("s", "xi", "mu", "u", "v", "w", "mu_c", "mu_r", "qss"))
    model = model.with_(equation_set="MoistEulerRLZ", grid_params=gp)
    grid = tx.create_grid(gp, F64, device="cpu")
    ctx = tmodel.build_context(model, grid, F64)
    rng = np.random.default_rng(5)
    phys = torch.from_numpy(rng.normal(size=(9,) + grid.spatial_shape) * 0.1)
    fields = grid.synthesis(grid.analysis(phys))
    eq = tmodel.get_equation_set("MoistEulerRLZ")
    wts = torch.from_numpy(rng.normal(size=(9,) + grid.spatial_shape))

    def loss(K):
        ctx.params = {**model.phys(), "K": K}
        return torch.sum(wts * eq(fields, ctx).expdot)

    K = torch.tensor(5.0, dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(loss(K), K)
    with torch.no_grad():
        fd = float((loss(6.0) - loss(4.0)) / 2.0)
    assert abs(float(g) - fd) <= 1e-6 * abs(fd), (float(g), fd)
