"""The port's compensated (bf16x3) matmul mode, the JAX package's TPU
numerics, against scythe_tpu on the same float32 inputs.

* _split3 / _bf16 equal the JAX package's bit for bit (bf16 bit patterns),
  and so does every operator stack of a compensated grid;
* the two gates of tests/test_compensated.py on the port: 3e-5 of the f64
  scale, and more than 20x closer to f64 than raw bf16 operators (which
  also shows that x_lo is not folded away);
* one compensated contraction (Grid._mm) against the JAX compensated _mm on
  the same f32 input: within 5e-7 of its max, the f32 summation order's
  grade, which a plain f32 einsum misses;
* the port's compensated analysis and synthesis, chains of contractions
  with the activation re-split between them, against the JAX compensated
  grid's on the same f32 inputs: within 3e-5 of each field's max, the JAX
  gate's own figure (measured on these grids: analysis up to 6e-6, project
  + solve_spectral 1.3e-5, synthesis 8e-6; each package is 5e-6 to 5e-5
  from f64: the two sum their f32 products in another order, and a split
  then rounds a few hi parts the other way, a bf16x2-sized step); with
  deriv_single on, the derivative slots within 1e-2 of each slot's max
  (measured up to 2.2e-3: one bf16 pass, so an f32-sized difference in its
  input moves a rounding by a bf16 step; each package is ~7e-3 from f64);
* 10 compensated moist RLZ steps through build_step in both packages,
  within 1e-4 of each field's max;
* the comp analysis' backward (the transposed chain of O_hi + O_lo in f32)
  against jax.grad through the compensated _mm, which rounds the cotangent
  to bf16 at its casts;
* the defaults: create_grid(matmul="auto") stays plain and not fast, on the
  card (a monkeypatched device check) and on the CPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import scythe_tpu as jx
import scythe_tpu_torch as tx
from scythe_tpu.grids import base as jbase
from scythe_tpu_torch.grids import base as tbase
from scythe_tpu_torch.ops import rlz_analysis

torch.set_num_threads(2)


def _bits_j(a):
    return np.asarray(a).view(np.uint16)


def _bits_t(t):
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def test_split3_and_bf16_bit_for_bit():
    rng = np.random.default_rng(0)
    ops = [rng.normal(size=(17, 23)) * 10.0 ** rng.uniform(-6, 6, size=(17, 23)),
           np.linspace(-1.0, 1.0, 101)[None],
           # halfway cases of the f32 -> bf16 rounding, ties to even
           np.array([[1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -(1.0 + 2.0 ** -8), 0.0]])]
    for op in ops:
        assert np.array_equal(_bits_t(tbase._split3(op)), _bits_j(jbase._split3(op)))
        assert np.array_equal(_bits_t(tbase._bf16(op)), _bits_j(jbase._bf16(op)))


def _params(pkg, geometry, deriv_single=None, l_factored=None):
    BC, ZBC = pkg.BC, pkg.ZBC
    kw = dict(geometry=geometry, xmin=0.0, xmax=100.0, num_cells=12, vars={"h": 1, "u": 2},
              BCL={"h": BC.R1T1}, deriv_single=deriv_single, l_factored=l_factored)
    if geometry in ("RL", "RLZ", "XYZ", "SL", "SLZ"):
        kw["lDim"] = 16
    if geometry in ("RZ", "RLZ", "XYZ", "SLZ"):
        kw.update(zmin=0.0, zmax=10.0, zDim=12, BCB={"u": ZBC.R1T0})
    if geometry == "XYZ":
        kw.update(ymin=0.0, ymax=50.0)
    if geometry in ("SL", "SLZ"):
        kw.update(xmin=-np.pi / 2, xmax=np.pi / 2)
    return pkg.GridParameters(**kw)


def _pair(geometry, **kw):
    gj = jx.create_grid(_params(jx, geometry, **kw), jnp.float32, matmul="compensated")
    gt = tx.create_grid(_params(tx, geometry, **kw), torch.float32, matmul="compensated",
                        device="cpu")
    return gj, gt


OPS = ("analysis_r", "project_r", "msolve_r", "synth_r", "synth_r_val", "l_analysis",
       "l_synth", "l_all", "analysis_z", "z_all", "z_synth_val", "zcol_int", "zcol_deriv",
       "zcol_filter", "zcol_deriv_ftop", "z_deriv_f", "l_deriv_f", "l_synth_f",
       "synth_r_deriv_f", "synth_r_val_f")


@pytest.mark.parametrize("geometry", ["R", "RL", "RZ", "RLZ", "XYZ", "SL", "SLZ"])
def test_compensated_grid_operators_equal_jax(geometry):
    """Every operator of a compensated grid (the [3, ...] stacks and the
    single-pass bf16 ones) holds the JAX package's bf16 values exactly."""
    gj, gt = _pair(geometry)
    assert gt.comp and gj.comp and gt.fast == gj.fast
    for name in OPS:
        a, b = getattr(gj, name), getattr(gt, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        assert b.dtype == torch.float32
        assert np.array_equal(b.numpy(), np.asarray(a, np.float32)), name
    assert np.array_equal(gt.ring_mask.numpy() if gt.ring_mask is not None else 0,
                          np.asarray(gj.ring_mask) if gj.ring_mask is not None else 0)


def _rl_gp(pkg):
    return pkg.GridParameters(geometry="RL", xmin=0.0, xmax=100.0, num_cells=24, lDim=32,
                              BCL={"h": pkg.BC.R1T1}, vars={"h": 1, "u": 2},
                              deriv_single=False)


def test_compensated_matches_plain_to_f32_grade():
    """tests/test_compensated.py's first gate on the port: analysis and every
    synthesis slot within 3e-5 of the f64 scale."""
    g64 = tx.create_grid(_rl_gp(tx), torch.float64, matmul="plain", device="cpu")
    gc = tx.create_grid(_rl_gp(tx), torch.float32, matmul="compensated", device="cpu")
    r = g64.r_mish[:, None]
    lam = np.linspace(0, 2 * np.pi, 32, endpoint=False)[None, :]
    f = np.stack([(r / 100.0) ** 2 * np.cos(2 * lam),
                  np.exp(-(((r - 50) / 30) ** 2)) * np.sin(lam)])
    spec64 = g64.analysis(torch.from_numpy(f))
    specc = gc.analysis(torch.from_numpy(f).float())
    scale = float(spec64.abs().max())
    assert float((specc.double() - spec64).abs().max()) < 3e-5 * scale
    out64 = g64.synthesis(spec64)
    outc = gc.synthesis(spec64.float())
    gscale = max(float(out64[k].abs().max()) for k in g64.field_keys)
    for key in g64.field_keys:
        assert float((outc[key].double() - out64[key]).abs().max()) < 3e-5 * gscale, key


def test_compensated_beats_single_pass_bf16():
    """The second gate: the 3-term scheme far closer to f64 than raw bf16
    operators (a scheme that folded x_lo away would be no better)."""
    g64 = tx.create_grid(_rl_gp(tx), torch.float64, matmul="plain", device="cpu")
    gc = tx.create_grid(_rl_gp(tx), torch.float32, matmul="compensated", device="cpu")
    f = torch.from_numpy(np.random.default_rng(1).normal(size=(2,) + g64.spatial_shape))
    s64 = g64.analysis(f)
    scomp = gc.analysis(f.float()).double()
    g16 = tx.create_grid(_rl_gp(tx), torch.float32, matmul="plain", device="cpu")
    g16.analysis_r = tbase.bf16_round(g16.analysis_r)
    g16.l_analysis = tbase.bf16_round(g16.l_analysis)
    s16 = g16.analysis(f.float()).double()
    scale = float(s64.abs().max())
    err_comp = float((scomp - s64).abs().max()) / scale
    err_16 = float((s16 - s64).abs().max()) / scale
    assert err_comp < 3e-5
    assert err_comp < err_16 / 20.0


def _per_field_close(got, ref, rel, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    for v in range(ref.shape[0]):
        scale = np.abs(ref[v]).max()
        err = np.abs(got[v] - ref[v]).max()
        assert err <= rel * scale, (what, v, err / scale)


COMP_REL = 3e-5  # the compensated scheme's grade (tests/test_compensated.py)
FAST_REL = 1e-2  # a single bf16 pass


@pytest.mark.parametrize("deriv_single", [None, False], ids=["fast", "all-comp"])
@pytest.mark.parametrize("geometry", ["R", "RL", "RZ", "RLZ", "XYZ", "SL", "SLZ"])
def test_compensated_transforms_match_jax(geometry, deriv_single):
    """The port's compensated analysis, project + solve_spectral and every
    synthesis slot against the JAX compensated grid's on the same f32
    inputs (the module docstring gives the bars)."""
    gj, gt = _pair(geometry, deriv_single=deriv_single)
    phys = np.random.default_rng(2).normal(size=(2,) + gj.spatial_shape).astype(np.float32)
    sj = np.asarray(gj.analysis(jnp.asarray(phys)))
    _per_field_close(gt.analysis(torch.from_numpy(phys)), sj, COMP_REL, "analysis")
    pj = np.asarray(gj.solve_spectral(gj.project(jnp.asarray(phys))))
    _per_field_close(gt.solve_spectral(gt.project(torch.from_numpy(phys))), pj, COMP_REL,
                     "project")
    oj, ot = gj.synthesis(jnp.asarray(sj)), gt.synthesis(torch.from_numpy(sj))
    for k in oj:
        _per_field_close(ot[k], oj[k], FAST_REL if gt.fast and k != "val" else COMP_REL, k)


ONE_MM_REL = 5e-7  # one compensated contraction: f32 summation order only
MM_CASES = (("RLZ", "l_analysis", "kl,vrlz->vrkz"), ("RLZ", "analysis_r", "vbr,vrkz->vbkz"),
            ("RLZ", "analysis_z", "vKz,vbkz->vbkK"), ("RLZ", "synth_r", "drb,vblz->vdrlz"),
            ("RLZ", "l_all", "dlk,vbkz->vdblz"), ("RLZ", "z_all", "dzK,vbkK->vdbkz"),
            ("RL", "l_synth", "lk,vbk->vbl"), ("RZ", "msolve_r", "vbc,vcz->vbz"))


@pytest.mark.parametrize("geometry,name,subs", MM_CASES, ids=[c[1] + "-" + c[0] for c in MM_CASES])
def test_one_compensated_contraction_matches_jax(geometry, name, subs):
    """One Grid._mm of a grid's own operator stack against the JAX
    compensated _mm on the same f32 input (spread over six decades): the
    splits are bit-identical and the bf16 products exact in f32, so the two
    differ by their f32 summation order alone, within 5e-7 of the output's
    max (measured up to 1.8e-7 over three seeds).  A plain f32 einsum by
    O_hi + O_lo misses that bar (measured 8.4e-7 to 1.2e-5): it keeps the
    lo x lo term and x unsplit."""
    gj, gt = _pair(geometry)
    opj, opt = getattr(gj, name), getattr(gt, name)
    a, rest = subs.split(",", 1)
    b = rest.split("->")[0]
    size = dict(zip(a, opt.shape[1:]))
    rng = np.random.default_rng(11)
    x = rng.normal(size=[2 if c == "v" else size.get(c, 5) for c in b]).astype(np.float32)
    x *= (10.0 ** rng.uniform(-3, 3, size=x.shape)).astype(np.float32)
    ref = np.asarray(gj._mm(subs, opj, jnp.asarray(x)), np.float64)
    scale = np.abs(ref).max()
    got = gt._mm(subs, opt, torch.from_numpy(x)).double().numpy()
    assert np.abs(got - ref).max() <= ONE_MM_REL * scale
    f32 = torch.einsum(subs, opt[0] + opt[1], torch.from_numpy(x)).double().numpy()
    assert np.abs(f32 - ref).max() > ONE_MM_REL * scale


@pytest.mark.parametrize("geometry", ["RLZ", "RL"])
def test_compensated_factored_transforms_match_jax(geometry):
    """The factored DFT's stages go through the compensated _mm too."""
    gj, gt = _pair(geometry, l_factored=True)
    assert gt.l_fact is not None and not gt.fast
    phys = np.random.default_rng(3).normal(size=(2,) + gj.spatial_shape).astype(np.float32)
    sj = np.asarray(gj.analysis(jnp.asarray(phys)))
    _per_field_close(gt.analysis(torch.from_numpy(phys)), sj, COMP_REL, "analysis")
    oj, ot = gj.synthesis(jnp.asarray(sj)), gt.synthesis(torch.from_numpy(sj))
    for k in oj:
        _per_field_close(ot[k], oj[k], COMP_REL, k)


def test_rlz_class_compensated_analysis_takes_the_comp_wrapper(monkeypatch):
    """A compensated RLZ-class grid with the dense DFT analyses through
    ops.rlz_analysis in comp mode, with its operator stacks."""
    _, gt = _pair("SLZ")
    seen = []
    real = rlz_analysis.rlz_analysis

    def spy(*a):
        seen.append(a[5])
        return real(*a)

    monkeypatch.setattr(rlz_analysis, "rlz_analysis", spy)
    phys = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2,) + gt.spatial_shape).astype(np.float32))
    got = gt.analysis(phys)
    assert seen == ["comp"]
    assert torch.equal(got, gt._analysis_with(gt.analysis_r, "vbr", phys))


# ---- a compensated moist RLZ run in both packages

VARS = {"s": 1, "xi": 2, "mu": 3, "u": 4, "v": 5, "w": 6, "mu_c": 7, "mu_r": 8, "qss": 9}


def _moist_model(pkg, tmp, n_steps, deriv_single=None):
    gp = pkg.GridParameters(
        geometry="RLZ", xmin=0.0, xmax=10000.0, num_cells=8, lDim=16, zmin=0.0,
        zmax=10000.0, zDim=16, BCL={"u": pkg.BC.R1T0, "v": pkg.BC.R1T0, "w": pkg.BC.R1T1},
        BCR={"u": pkg.BC.R1T0, "v": pkg.BC.R0}, vars=VARS, deriv_single=deriv_single)
    return pkg.ModelParameters(
        ts=0.25, integration_time=n_steps * 0.25, output_interval=n_steps * 0.25,
        equation_set="MoistEulerRLZ", initial_conditions=str(tmp / "ics.csv"),
        output_dir=str(tmp / "out"), ref_state_file=str(tmp / "sounding.txt"),
        grid_params=gp, physical_params={"K": 10.0, "f": 5.0e-5},
        options={"semiimplicit": True})


@pytest.fixture(scope="module")
def moist_case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compensated_moist")
    zs = np.linspace(0.0, 12000.0, 40)
    theta, qv = 300.0 + 0.004 * zs, 14.0 * np.exp(-zs / 2500.0)
    with open(tmp / "sounding.txt", "w") as f:
        f.write(f"1015.0 {theta[0]} {qv[0]}\n")
        for z, th, q in zip(zs[1:], theta[1:], qv[1:]):
            f.write(f"{z} {th} {q}\n")
    grid = tx.create_grid(_moist_model(tx, tmp, 1).grid_params, torch.float64, device="cpu")
    pts = grid.gridpoints()
    r, lam, z = pts[:, 0], pts[:, 1], pts[:, 2]
    rad = np.sqrt(((r * np.cos(lam) - 4000.0) / 1500.0) ** 2
                  + (r * np.sin(lam) / 1500.0) ** 2 + ((z - 2000.0) / 1500.0) ** 2)
    cols = np.zeros((len(r), 3 + len(VARS)))
    cols[:, :3] = pts
    cols[:, 3] = 3.0 * np.maximum(0.0, np.cos(np.pi * np.minimum(rad, 1.0) / 2.0)) ** 2
    np.savetxt(tmp / "ics.csv", cols, delimiter=",", comments="", fmt="%.17g",
               header="r,l,z," + ",".join(VARS))
    return tmp


def _compensated_create_grid(monkeypatch, jmodel, tmodel):
    """Both model modules build compensated grids, as the JAX package's
    auto does on a TPU."""
    real_j, real_t = jmodel.create_grid, tmodel.create_grid
    monkeypatch.setattr(jmodel, "create_grid",
                        lambda gp, dtype: real_j(gp, dtype, matmul="compensated"))
    monkeypatch.setattr(tmodel, "create_grid",
                        lambda gp, dtype, device: real_t(gp, dtype, matmul="compensated",
                                                         device=device))


@pytest.mark.parametrize("deriv_single,rel", [(False, 1e-4), (None, 1e-3)],
                         ids=["all-comp", "fast"])
def test_ten_compensated_moist_steps_match_jax(moist_case, monkeypatch, deriv_single, rel):
    """10 MoistEulerRLZ steps (semi-implicit) on compensated f32 grids
    through initialize + build_step in both packages.  Every GEMM
    compensated: within 1e-4 of each field's max (measured 1.1e-5).  With
    deriv_single auto (on, the TPU's production numerics): 1e-3 (measured
    2.2e-4): the derivative slots are one bf16 pass, so an f32-sized
    difference moves a rounding by a bf16 step, and that grows over the
    steps; each package is 1.2e-3 to 2.6e-3 from the f64 run there.  The
    packages build their grids with matmul="auto" (compensated on a TPU
    only), so each create_grid is asked for the compensated mode here."""
    from scythe_tpu import model as jmodel
    from scythe_tpu_torch import model as tmodel

    _compensated_create_grid(monkeypatch, jmodel, tmodel)
    mj = _moist_model(jx, moist_case, 10, deriv_single)
    gj, cj, sj = jmodel.initialize(mj, jnp.float32)
    assert gj.comp and gj.fast == (deriv_single is None)
    oj = jmodel.make_scan(jmodel.build_step(mj, gj, cj, jnp.float32), 10)(sj)
    mt = _moist_model(tx, moist_case, 10, deriv_single)
    gt, ct, st = tmodel.initialize(mt, torch.float32, device="cpu")
    assert gt.comp and gt.fast == (deriv_single is None)
    ot = tmodel.make_scan(tmodel.build_step(mt, gt, ct, torch.float32), 10)(st)
    pj = np.asarray(gj.synthesis(oj.spec)["val"])
    pt = gt.synthesis(ot.spec)["val"].numpy()
    assert np.isfinite(pt).all() and pt[5].max() > 0.0
    checked = np.abs(pj).reshape(9, -1).max(axis=1) > 0
    _per_field_close(pt[checked], pj[checked], rel, "10 compensated steps")


def test_compensated_state_carries_from_jax(moist_case, monkeypatch):
    """A JAX state of a compensated grid carries across
    (convert.state_from_numpy) and one compensated step (every GEMM
    compensated) of each package from it agrees within 1e-4 of each field's
    spectral max (measured 3.7e-5), the bar of the ten-step run."""
    from scythe_tpu import model as jmodel
    from scythe_tpu_torch import convert, model as tmodel

    _compensated_create_grid(monkeypatch, jmodel, tmodel)
    mj, mt = _moist_model(jx, moist_case, 1, False), _moist_model(tx, moist_case, 1, False)
    gj, cj, sj = jmodel.initialize(mj, jnp.float32)
    sj = jmodel.make_scan(jmodel.build_step(mj, gj, cj, jnp.float32), 10)(sj)
    gt, ct, _ = tmodel.initialize(mt, torch.float32, device="cpu")
    state = convert.state_from_numpy(sj, device="cpu")
    assert state.t == 11 and state.spec.dtype == torch.float32
    want = np.asarray(jmodel.build_step(mj, gj, cj, jnp.float32)(sj).spec)
    got = tmodel.build_step(mt, gt, ct, torch.float32)(state).spec.numpy()
    _per_field_close(got, want, 1e-4, "one step from the JAX state")


def test_comp_analysis_backward_against_jax_grad():
    """The comp analysis' backward is the transposed chain of the operators
    O_hi + O_lo in f32; jax.grad through the compensated _mm rounds each
    cotangent to bf16 at its casts.  The two agree to the bf16 grade that
    rounding gives: 1e-2 of the gradient's max (measured ~4e-3); the port's
    is within 3e-5 of the f64 chain's gradient, JAX's is not."""
    gj, gt = _pair("RLZ")
    g64 = tx.create_grid(_params(tx, "RLZ"), torch.float64, device="cpu")
    rng = np.random.default_rng(6)
    phys = rng.normal(size=(2,) + gj.spatial_shape).astype(np.float32)
    wts = rng.normal(size=(2,) + gj.spectral_shape[1:]).astype(np.float32)
    gjax = np.asarray(jax.grad(lambda p: jnp.sum(gj.analysis(p) * wts))(jnp.asarray(phys)))
    x = torch.from_numpy(phys).requires_grad_(True)
    (gtorch,) = torch.autograd.grad((gt.analysis(x) * torch.from_numpy(wts)).sum(), x)
    x64 = torch.from_numpy(phys).double().requires_grad_(True)
    (g_ref,) = torch.autograd.grad((g64.analysis(x64) * torch.from_numpy(wts).double()).sum(),
                                   x64)
    scale = float(g_ref.abs().max())
    assert float((gtorch.double() - g_ref).abs().max()) <= 3e-5 * scale
    assert np.abs(gtorch.numpy() - gjax).max() <= 1e-2 * scale
    assert np.abs(gjax - g_ref.numpy()).max() > 3e-5 * scale  # JAX's is bf16-grade


def test_defaults_stay_plain(monkeypatch):
    """matmul="auto" resolves to plain (and so not fast) on the card and on
    the CPU, whatever deriv_single says: no default run of the port
    changes."""
    gp = _params(tx, "RLZ", deriv_single=True)
    g = tx.create_grid(gp, torch.float32, device="cpu")
    assert not g.comp and not g.fast and g.analysis_r.ndim == 3
    # the card: resolve_device's check passes, the operators stay on the CPU
    monkeypatch.setattr(tbase, "resolve_device", lambda d: torch.device("cpu"))
    g = tx.create_grid(gp, torch.float32, matmul="auto", device="cuda")
    assert not g.comp and not g.fast
    with pytest.raises(ValueError, match="compensated"):
        tx.create_grid(gp, torch.float32, matmul="bf16", device="cpu")


def test_compensated_float32_grid_refuses_tf32(monkeypatch):
    """A compensated float32 grid on the card refuses TF32 like a plain one."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        tx.create_grid(_params(tx, "RL"), torch.float32, matmul="compensated",
                       device="cuda")
