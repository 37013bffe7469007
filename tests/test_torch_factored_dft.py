"""The port's radix-split (factored) azimuthal DFT against the dense path and
against scythe_tpu: every test of tests/test_factored_dft.py on the port
(operators against dense for several nl, the ring mask's kmax, grid
transforms on RL / RLZ, a trajectory, the auto fallback, XYZ and SL, the
XYZ box at 4096), then the port against the JAX package at float64: the
numpy operators array-equal, the transforms within 1e-12 of each slot's max,
15 steps within 1e-9, and the modal filter's per-slot wavenumbers."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import scythe_tpu as jx
import scythe_tpu_torch as tx
from scythe_tpu.basis import fourier_factored as jff
from scythe_tpu_torch.basis import fourier, fourier_factored as ff

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("nl", [16, 24, 64, 128])
def test_factored_matches_dense_operators(nl):
    fd = ff.FactoredDFT(nl)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, nl))
    la, ls, ld, ld2 = fourier.dft_matrices(nl)
    c = ff.analysis_np(fd, x)
    assert np.abs(ff.synthesis_np(fd, c, 0) - x).max() < 1e-12
    assert np.abs(ff.synthesis_np(fd, c, 1) - (ld @ (la @ x.T)).T).max() < 1e-10
    assert np.abs(ff.synthesis_np(fd, c, 2) - (ld2 @ (la @ x.T)).T).max() < 1e-8


def test_factored_ring_mask_matches_dense_kmax():
    """Same retained wavenumbers per ring as the dense mask."""
    nl = 64
    fd = ff.FactoredDFT(nl)
    r = np.linspace(500.0, 3.0e5, 60)
    mf = fd.ring_mask(r, 3000.0)
    md = fourier.ring_coeff_mask(r, 3000.0, nl)
    kd = fourier.coeff_wavenumbers(nl)
    for i in range(len(r)):
        assert set(fd.k_of_slot[mf[i] > 0]) == set(kd[md[i] > 0]), i


@pytest.mark.parametrize("nl", [16, 24, 64, 128, 4096])
def test_numpy_operators_array_equal_to_jax(nl):
    """The verbatim numpy half: every operator and mask equal to the JAX
    module's, bit for bit."""
    a, b = ff.FactoredDFT(nl), jff.FactoredDFT(nl)
    assert ff.split_radix(nl) == jff.split_radix(nl)
    for name in ("W2a", "Ta", "W1a", "kmap", "base_mask", "k_of_slot", "w_synth", "k_d",
                 "k_d2", "W1s", "Ts", "W2s"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert (a.n1, a.n2, a.n1h, a.K) == (b.n1, b.n2, b.n1h, b.K)
    r = np.linspace(500.0, 3.0e5, 12)
    assert np.array_equal(a.ring_mask(r, 3000.0, 1.5), b.ring_mask(r, 3000.0, 1.5))
    x = np.random.default_rng(3).normal(size=(2, nl))
    c = ff.analysis_np(a, x)
    assert np.array_equal(c, jff.analysis_np(b, x))
    for d in (0, 1, 2):
        assert np.array_equal(ff.synthesis_np(a, c, d), jff.synthesis_np(b, c, d))


def _common(pkg, geometry, nl):
    common = dict(geometry=geometry, xmin=0.0, xmax=1.0e5, num_cells=8, lDim=nl,
                  BCL={"a": pkg.BC.R1T1, "b": pkg.BC.R1T0},
                  BCR={"a": pkg.BC.R0, "b": pkg.BC.R0}, vars={"a": 1, "b": 2})
    if geometry == "RLZ":
        common.update(zmin=0.0, zmax=1.0e4, zDim=8)
    if geometry == "XYZ":
        common.update(xmax=1.2e4, ymin=0.0, ymax=8.0e3, zmin=0.0, zmax=1.0e4, zDim=8)
    if geometry == "SL":
        common.update(xmin=-np.pi / 2, xmax=np.pi / 2,
                      BCR={"a": pkg.BC.R1T1, "b": pkg.BC.R1T0})
    if geometry == "SLZ":
        common.update(xmin=-np.pi / 2, xmax=np.pi / 2, zmin=0.0, zmax=1.0e4, zDim=8,
                      BCR={"a": pkg.BC.R1T1, "b": pkg.BC.R1T0})
    return common


def _grids(geometry, nl):
    common = _common(tx, geometry, nl)
    gd = tx.create_grid(tx.GridParameters(l_factored=False, **common), torch.float64,
                        "plain", device="cpu")
    gf = tx.create_grid(tx.GridParameters(l_factored=True, **common), torch.float64,
                        "plain", device="cpu")
    return gd, gf


def _dense_vs_factored(geometry, nl=16):
    gd, gf = _grids(geometry, nl)
    phys = _t(np.random.default_rng(1).normal(size=(2,) + gd.spatial_shape))
    fd = gd.synthesis(gd.analysis(phys))
    ffld = gf.synthesis(gf.analysis(phys))
    assert gf.spectral_shape[2] == gf.l_fact.fd.K == gf.kDim
    for key in gd.field_keys:
        err = float((fd[key] - ffld[key]).abs().max())
        scale = float(fd[key].abs().max()) + 1e-30
        assert err / scale < 1e-11, (key, err, scale)


@pytest.mark.parametrize("geometry", ["RL", "RLZ"])
def test_grid_transforms_match_dense(geometry):
    _dense_vs_factored(geometry)


@pytest.mark.parametrize("geometry", ["XYZ", "SL", "SLZ"])
def test_xyz_sl_factored_matches_dense(geometry):
    """The factored mask plumbing of the other periodic axes: XYZ's uniform
    2/3-rule mask with the d/dy scale, the a cos(lat) ring mask of SL/SLZ."""
    _dense_vs_factored(geometry)


def test_factored_rlz_class_takes_the_einsum_analysis(monkeypatch):
    """The analysis kernel takes the dense DFT only (as the TPU kernel): a
    factored RLZ-class grid never reaches ops.rlz_analysis."""
    from scythe_tpu_torch.ops import rlz_analysis

    _, gf = _grids("RLZ", 16)

    def boom(*a, **k):
        raise AssertionError("a factored grid reached the analysis kernel's wrapper")

    monkeypatch.setattr(rlz_analysis, "rlz_analysis", boom)
    phys = _t(np.random.default_rng(2).normal(size=(2,) + gf.spatial_shape))
    assert gf.analysis(phys).shape == (2,) + gf.spectral_shape[1:]


def _cb_model(pkg, tmp_path, factored):
    BC = pkg.BC
    gp = pkg.GridParameters(
        geometry="RL", xmin=0.0, xmax=3.0e5, num_cells=16, lDim=16, l_factored=factored,
        BCL={"h": BC.R1T1, "u": BC.R1T0, "v": BC.R1T0, "ub": BC.R1T0, "vb": BC.R1T0,
             "wb": BC.R1T1},
        BCR={"h": BC.R0, "u": BC.R1T1, "v": BC.R0, "ub": BC.R1T1, "vb": BC.R0,
             "wb": BC.R0},
        vars={"h": 1, "u": 2, "v": 3, "ub": 4, "vb": 5, "wb": 6},
    )
    return pkg.ModelParameters(
        ts=3.0, integration_time=45.0, output_interval=45.0,
        equation_set="Twoway_ShallowWater_Slab",
        initial_conditions=str(tmp_path / "ics.csv"), output_dir=str(tmp_path / "out"),
        grid_params=gp,
        physical_params={"g": 9.81, "K": 5000.0, "Cd": 2.4e-3, "Hfree": 2000.0,
                         "Hb": 1000.0, "f": 5.0e-5, "S1": 1.0e-5},
    )


def _write_cb_ics(tmp_path):
    grid = tx.create_grid(_cb_model(tx, tmp_path, False).grid_params, torch.float64,
                          device="cpu")
    pts = grid.gridpoints()
    r, lam = pts[:, 0], pts[:, 1]
    v = np.where(r < 5e4, 20.0 * r / 5e4, 20.0 * 5e4 / r) * (1.0 + 0.05 * np.cos(2 * lam))
    with open(tmp_path / "ics.csv", "w") as f:
        f.write("r,l,h,u,v,ub,vb,wb\n")
        for i in range(len(r)):
            f.write(f"{r[i]},{lam[i]},0.0,0.0,{v[i]},0.0,{0.8 * v[i]},0.0\n")


def test_trajectory_matches_dense_and_jax(tmp_path):
    """15 steps of the two-layer slab model: factored equals dense to 1e-11
    (tests/test_factored_dft.py's check) and the port's factored run equals
    the JAX package's within 1e-9 of each field's max."""
    from scythe_tpu.model import build_step as jbuild, initialize as jinit, make_scan
    from scythe_tpu_torch import model as tmodel

    _write_cb_ics(tmp_path)
    outs = {}
    for factored in (False, True):
        m = _cb_model(tx, tmp_path, factored)
        grid, ctx, state = tmodel.initialize(m, torch.float64, device="cpu")
        assert (grid.l_fact is not None) == factored
        out = tmodel.make_scan(tmodel.build_step(m, grid, ctx, torch.float64), 15)(state)
        outs[factored] = grid.synthesis(out.spec)["val"].numpy()
    np.testing.assert_allclose(outs[True], outs[False], rtol=1e-11, atol=1e-11)
    mj = _cb_model(jx, tmp_path, True)
    gj, cj, sj = jinit(mj, jnp.float64)
    ref = np.asarray(gj.synthesis(make_scan(jbuild(mj, gj, cj, jnp.float64), 15)(sj).spec)["val"])
    for v in range(ref.shape[0]):
        scale = np.abs(ref[v]).max()
        assert np.abs(outs[True][v] - ref[v]).max() <= 1e-9 * max(scale, 1e-300), v


def test_auto_factored_falls_back_for_unfactorable_nl():
    """nl = 2 x odd (514) has no even x even split: auto takes the dense DFT."""
    gp = tx.GridParameters(geometry="RL", xmin=0.0, xmax=1.0e5, num_cells=8, lDim=514,
                           BCL={"a": tx.BC.R0}, BCR={"a": tx.BC.R0}, vars={"a": 1})
    g = tx.create_grid(gp, torch.float64, "plain", device="cpu")
    assert g.l_fact is None and g.kDim == 514


def test_explicit_factored_unfactorable_nl_raises_the_reason():
    gp = tx.GridParameters(geometry="RL", xmin=0.0, xmax=1.0e5, num_cells=8, lDim=514,
                           l_factored=True, vars={"a": 1})
    with pytest.raises(ValueError, match="even x even"):
        tx.create_grid(gp, torch.float64, device="cpu")


def _xyz_4096(pkg):
    return pkg.GridParameters(geometry="XYZ", xmin=0.0, xmax=1.2e4, num_cells=4,
                              lDim=4096, ymin=0.0, ymax=8.0e3, zmin=0.0, zmax=1.0e4,
                              zDim=6, vars={"a": 1})


def test_xyz_lifted_cap_builds_at_4096():
    """lDim = 4096 on XYZ builds (auto: factored) and round-trips a resolved
    mode."""
    grid = tx.create_grid(_xyz_4096(tx), torch.float64, "plain", device="cpu")
    assert grid.l_fact is not None and grid.kDim == grid.l_fact.fd.K
    y = grid.gridpoints()[:, 1].reshape(grid.spatial_shape)
    f = np.sin(2 * np.pi * 5 * y / 8.0e3)
    out = grid.synthesis(grid.analysis(_t(f[None])))
    assert float((out["val"][0] - _t(f)).abs().max()) < 1e-8


GEOMS = ("RL", "RLZ", "XYZ", "SL", "SLZ")


@pytest.mark.parametrize("geometry", GEOMS)
def test_factored_grid_matches_jax(geometry):
    """The factored grid of each periodic geometry against scythe_tpu's at
    float64: masks and operators array-equal, analysis, project +
    solve_spectral and every synthesis slot within 1e-12 of its max."""
    gj = jx.create_grid(jx.GridParameters(l_factored=True, **_common(jx, geometry, 16)),
                        jnp.float64, "plain")
    gt = tx.create_grid(tx.GridParameters(l_factored=True, **_common(tx, geometry, 16)),
                        torch.float64, "plain", device="cpu")
    assert gt.kDim == gj.kDim and gt.spectral_shape == gj.spectral_shape
    assert np.array_equal(gt.ring_mask.numpy(), np.asarray(gj.ring_mask))
    for name in ("W2a", "W1a", "W1s", "W2s", "Ta", "Ts", "w_synth", "k_d", "k_d2"):
        assert np.array_equal(getattr(gt.l_fact, name).numpy(),
                              np.asarray(getattr(gj.l_fact, name))), name
    phys = np.random.default_rng(4).normal(size=(2,) + gj.spatial_shape)
    sj = np.asarray(gj.analysis(jnp.asarray(phys)))
    st = gt.analysis(_t(phys)).numpy()
    assert np.abs(st - sj).max() <= 1e-12 * np.abs(sj).max()
    pj = np.asarray(gj.solve_spectral(gj.project(jnp.asarray(phys))))
    pt = gt.solve_spectral(gt.project(_t(phys))).numpy()
    assert np.abs(pt - pj).max() <= 1e-12 * np.abs(pj).max()
    oj, ot = gj.synthesis(jnp.asarray(sj)), gt.synthesis(_t(sj))
    assert set(ot) == set(oj)
    for k in oj:
        ref = np.asarray(oj[k])
        assert np.abs(ot[k].numpy() - ref).max() <= 1e-12 * np.abs(ref).max(), k


def test_auto_factors_above_2048_like_jax():
    """Auto: factored beyond nl = 2048 (RL at its default nl cap), dense at
    2048, in both packages."""
    for nl, want in ((2048, False), (4096, True)):
        kw = dict(geometry="RL", xmin=0.0, xmax=1.0e5, num_cells=4, lDim=nl, vars={"a": 1})
        gt = tx.create_grid(tx.GridParameters(**kw), torch.float64, device="cpu")
        gj = jx.create_grid(jx.GridParameters(**kw), jnp.float64, "plain")
        assert (gt.l_fact is not None) == (gj.l_fact is not None) == want, nl
        assert gt.kDim == gj.kDim


@pytest.mark.parametrize("geometry", ["RL", "RLZ"])
def test_modal_filter_takes_the_factored_wavenumbers(geometry):
    """build_modal_filter on a factored grid: its per-slot |k| from the
    factored layout, the filter equal to the JAX package's (1e-12)."""
    from scythe_tpu.model import build_modal_filter as jfilter
    from scythe_tpu_torch.model import build_modal_filter as tfilter

    gj = jx.create_grid(jx.GridParameters(l_factored=True, **_common(jx, geometry, 16)),
                        jnp.float64, "plain")
    gt = tx.create_grid(tx.GridParameters(l_factored=True, **_common(tx, geometry, 16)),
                        torch.float64, "plain", device="cpu")
    k = gt.slot_wavenumbers()
    assert k.shape == (gt.kDim,)
    assert np.array_equal(k, gt.l_fact.fd.k_of_slot.astype(np.float64))
    spec = np.random.default_rng(5).normal(size=gj.spectral_shape)
    for axes in ("rlz", "l"):
        fj = np.asarray(jfilter(gj, 30.0, 8, 3.0, jnp.float64, axes)(jnp.asarray(spec)))
        ft = tfilter(gt, 30.0, 8, 3.0, torch.float64, axes)(_t(spec)).numpy()
        assert np.abs(ft - fj).max() <= 1e-12 * np.abs(fj).max(), axes


def test_factored_state_carries_from_jax(tmp_path):
    """A JAX state on a factored grid (the K_f slot layout) carries across
    through convert.state_from_numpy, and one step of each package from it
    agrees within 1e-12."""
    from scythe_tpu.model import build_step as jbuild, initialize as jinit
    from scythe_tpu_torch import convert, model as tmodel

    _write_cb_ics(tmp_path)
    mj, mt = _cb_model(jx, tmp_path, True), _cb_model(tx, tmp_path, True)
    gj, cj, sj = jinit(mj, jnp.float64)
    gt, ct, _ = tmodel.initialize(mt, torch.float64, device="cpu")
    state = convert.state_from_numpy(sj, device="cpu")
    assert tuple(state.spec.shape) == gt.spectral_shape == gj.spectral_shape
    want = np.asarray(jbuild(mj, gj, cj, jnp.float64)(sj).spec)
    got = tmodel.build_step(mt, gt, ct, torch.float64)(state).spec.numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
