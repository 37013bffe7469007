"""Radial domain decomposition of the port (scythe_tpu_torch.parallel): the
sharded step on a ThreadMesh must match the port's single-device step.

The invariance cases of tests/test_sharding.py, run on the port at float64
on the CPU with 8 shards (the JAX tests' 8 virtual devices) by psum, halo
(gather) and halo-pcr, each held at its JAX test's tolerance (1e-12; the
compensated + fast-derivative case 1e-3 of the state's max; Williamson 5
rtol 1e-10 with an absolute floor of 1e-12 of the max).  On the moist RZ
setup the port's sharded run is held against the JAX package's sharded run
too (1e-12).  The configurations are the JAX tests' own setups, converted
to the port's parameters.  Then the mesh itself: a shard that raises makes
the run raise within seconds, a shard's grid refuses a bare analysis, and
the collectives keep their results under a stress of many shards.
"""

import dataclasses
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scythe_tpu.model import make_scan as j_make_scan
from scythe_tpu.parallel import sharding as jsh

import scythe_tpu_torch as tx
from scythe_tpu_torch import io as sio
from scythe_tpu_torch import model as tmodel
from scythe_tpu_torch import timeintegration as tti
from scythe_tpu_torch.parallel import mesh as tmesh
from scythe_tpu_torch.parallel import sharding as sh

import test_sharding as jts

torch.set_num_threads(2)

METHODS = ["psum", "halo", "halo-pcr"]


def port_params(jgp):
    """A JAX GridParameters as the port's."""
    names = jgp.vars
    kw = {f.name: getattr(jgp, f.name) for f in dataclasses.fields(tx.GridParameters)}
    for k, enum in (("BCL", tx.BC), ("BCR", tx.BC), ("BCB", tx.ZBC), ("BCT", tx.ZBC)):
        kw[k] = {n: enum[b.name] for n, b in zip(names, kw[k])}
    return tx.GridParameters(**kw)


def port_model(jm, **opts):
    """A JAX ModelParameters as the port's (``opts`` added to its options)."""
    return tx.ModelParameters(
        ts=jm.ts, integration_time=jm.integration_time,
        output_interval=jm.output_interval, equation_set=jm.equation_set,
        initial_conditions=jm.initial_conditions, output_dir=jm.output_dir,
        ref_state_file=jm.ref_state_file, grid_params=port_params(jm.grid_params),
        physical_params=jm.phys(), options={**jm.opts(), **opts},
    )


def split_method(method):
    return ("halo", "pcr") if method == "halo-pcr" else (method, "gather")


def single_run(model, n_steps, dtype=torch.float64):
    grid, ctx, state = tmodel.initialize(model, dtype, device="cpu")
    return tmodel.make_scan(tmodel.build_step(model, grid, ctx, dtype), n_steps)(state)


def sharded_run(model, n_steps, method, n=8, dtype=torch.float64, matmul="auto"):
    """(canonical spectral state, expdot_nm1) after ``n_steps`` on ``n``
    thread-shards."""
    method, interface = split_method(method)
    mesh = sh.make_mesh(n, device="cpu")
    grid, ctx, state = sh.initialize_sharded(model, mesh, dtype, method, matmul=matmul,
                                             device="cpu")
    step = sh.build_sharded_step(model, grid, ctx, dtype, mesh, method, interface)
    out = tmodel.make_scan(step, n_steps)(state)
    spec = sh.gather_global(out.spec)
    if method == "halo":
        spec = sh.blocks_to_spec(spec, n, grid.params.num_cells // n)
    return spec.numpy(), sh.gather_global(out.expdot_nm1).numpy()


SETUPS = {"advection": jts._advection_setup, "slab": jts._slab_setup,
          "euler_rz": jts._euler_rz_setup, "moist_rz": jts._moist_rz_setup}


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("setup", SETUPS)
def test_sharded_matches_single(tmp_path, setup, method):
    """tests/test_sharding.py:179 on the port: 10 steps, 1e-12."""
    model = port_model(SETUPS[setup](tmp_path))
    ref = single_run(model, 10)
    spec, e1 = sharded_run(model, 10, method)
    np.testing.assert_allclose(spec, ref.spec.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(e1, ref.expdot_nm1.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("method", METHODS)
def test_moist_rz_sharded_matches_jax_sharded(tmp_path, method):
    """The hard path (Helmholtz column solve + condensation) on 8 shards:
    the port's sharded run against the JAX package's build_sharded_step
    over its 8 virtual devices, 10 steps, 1e-12."""
    jm = jts._moist_rz_setup(tmp_path)
    m, interface = split_method(method)
    mesh = jsh.make_mesh(8)
    grid, ctx, state = jsh.initialize_sharded(jm, mesh, method=m)
    jstep = jsh.build_sharded_step(jm, grid, ctx, jnp.float64, mesh, m, interface)
    out = j_make_scan(jstep, 10)(state)
    want = np.asarray(out.spec)
    if m == "halo":
        want = np.asarray(jsh.blocks_to_spec(out.spec, 8, grid.params.num_cells // 8))
    spec, _ = sharded_run(port_model(jm), 10, method)
    np.testing.assert_allclose(spec, want, rtol=1e-12, atol=1e-12)


def test_mesh_size_must_divide_cells(tmp_path):
    """tests/test_sharding.py:208."""
    model = port_model(jts._advection_setup(tmp_path, num_cells=97))
    with pytest.raises(ValueError, match="divisible"):
        sh.initialize_sharded(model, sh.make_mesh(8, device="cpu"), torch.float64,
                              device="cpu")


@pytest.mark.parametrize("method", METHODS)
def test_sharded_matches_single_fastderiv(tmp_path, method):
    """tests/test_sharding.py:216: compensated + single-pass bf16 derivative
    grids through the sharded paths, f32, 5 steps, 1e-3 of the state's max
    (f32 sum-order noise; a slicing fault would be O(1))."""
    model = port_model(jts._slab_setup(tmp_path))
    grid = tx.create_grid(model.grid_params, torch.float32, matmul="compensated",
                          device="cpu")
    assert grid.fast
    ctx = tmodel.build_context(model, grid, torch.float32)
    spec0 = grid.analysis(torch.as_tensor(
        sio.read_physical_grid(model.initial_conditions, grid), dtype=torch.float32))
    state = tti.initial_state(spec0, (grid.nvars,) + grid.spatial_shape, torch.float32)
    ref = tmodel.make_scan(tmodel.build_step(model, grid, ctx, torch.float32), 5)(state)
    spec, _ = sharded_run(model, 5, method, dtype=torch.float32, matmul="compensated")
    want = ref.spec.numpy()
    assert np.abs(spec - want).max() < 1e-3 * np.abs(want).max()


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("setup", ["advection", "slab", "moist_rz"])
def test_modal_filter_sharded_matches_single(tmp_path, setup, method):
    """tests/test_sharding.py:265: the per-step modal filter composes with
    every sharded analysis (the halo path gathers the windows at filter
    time), 5 steps, 1e-12."""
    model = port_model(SETUPS[setup](tmp_path), modal_filter_tau=30.0)
    ref = single_run(model, 5)
    spec, _ = sharded_run(model, 5, method)
    np.testing.assert_allclose(spec, ref.spec.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("method", METHODS)
def test_implicit_vdiff_sharded_matches_single(tmp_path, method):
    """tests/test_sharding.py:356: MoistEulerRLZ with implicit vertical
    diffusion and Smagorinsky (the per-ring spacing sliced a shard), 6
    steps, 1e-12."""
    model = port_model(jts._moist_rlz_ivd_setup(tmp_path))
    ref = single_run(model, 6)
    spec, _ = sharded_run(model, 6, method)
    np.testing.assert_allclose(spec, ref.spec.numpy(), rtol=1e-12, atol=1e-12)


def test_modal_filter_periodic_seam_uniform():
    """tests/test_sharding.py:382 on the port: the periodic radial filter
    factor is translation-invariant across the cell seam, 1e-10 / 1e-12."""
    gp = tx.GridParameters(geometry="R", xmin=0.0, xmax=96.0, num_cells=32,
                           BCL={"u": tx.BC.PERIODIC}, BCR={"u": tx.BC.PERIODIC},
                           vars={"u": 1})
    grid = tx.create_grid(gp, torch.float64, device="cpu")
    filt = tmodel.build_modal_filter(grid, tau=10.0, order=4, ts=1.0, dtype=torch.float64)
    r = grid.r_mish
    dx = 96.0 / 32
    f = np.exp(-(((r - 20.0) % 96.0 - 48.0) / 6.0) ** 2) + 0.3 * np.sin(
        2 * np.pi * 5 * r / 96.0)
    f_shift = np.exp(-(((r - 20.0 - dx) % 96.0 - 48.0) / 6.0) ** 2) + 0.3 * np.sin(
        2 * np.pi * 5 * (r - dx) / 96.0)
    out = grid.synthesis(filt(grid.analysis(torch.from_numpy(f[None]))))["val"][0]
    out_s = grid.synthesis(filt(grid.analysis(torch.from_numpy(f_shift[None]))))["val"][0]
    np.testing.assert_allclose(np.roll(out.numpy(), 3), out_s.numpy(), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("method", METHODS)
def test_sharded_topography_matches_single(tmp_path, method):
    """tests/test_sharding.py:457: Williamson 5 through the file-driven
    topography; the mountain reaches every shard (hs_grad sliced), 10
    steps, rtol 1e-10 and 1e-12 of the state's max."""
    model = port_model(jts._williamson5_setup(tmp_path))
    grid, ctx, state = tmodel.initialize(model, torch.float64, device="cpu")
    assert "hs_grad" in ctx.extras
    ref = tmodel.make_scan(tmodel.build_step(model, grid, ctx, torch.float64), 10)(state)
    m, _ = split_method(method)
    _, ctx2, _ = sh.initialize_sharded(model, sh.make_mesh(8, device="cpu"),
                                       torch.float64, m, device="cpu")
    assert "hs_grad" in ctx2.extras
    spec, _ = sharded_run(model, 10, method)
    want = ref.spec.numpy()
    np.testing.assert_allclose(spec, want, rtol=1e-10, atol=1e-12 * np.abs(want).max())


# ------------------------------------------------------------ the mesh itself


def _analysis_mesh(n=4):
    return tmesh.ThreadMesh(n, "cpu", timeout=30.0)


def test_a_shard_that_raises_ends_the_run_within_seconds():
    """One shard fails before a collective the others wait at: every other
    shard is released, and run re-raises the first error, long before the
    mesh's timeout."""
    mesh = _analysis_mesh()

    def body(x):
        if mesh.index == 2:
            raise ZeroDivisionError("shard 2 fails")
        return mesh.psum(x)

    t0 = time.perf_counter()
    with pytest.raises(ZeroDivisionError, match="shard 2 fails"):
        mesh.run(body, [torch.ones(3)] * 4)
    assert time.perf_counter() - t0 < 5.0
    # the mesh runs again afterwards
    out = mesh.run(mesh.psum, [torch.full((2,), float(i)) for i in range(4)])
    assert all(torch.equal(o, torch.full((2,), 6.0)) for o in out)


def test_a_shard_that_skips_a_collective_fails_the_run():
    mesh = tmesh.ThreadMesh(2, "cpu", timeout=30.0)

    def body(x):
        return x if mesh.index == 0 else mesh.psum(x)

    with pytest.raises(RuntimeError, match="never reached"):
        mesh.run(body, [torch.ones(1)] * 2)


def test_a_shard_that_waits_too_long_fails_the_run():
    mesh = tmesh.ThreadMesh(2, "cpu", timeout=0.5)

    def body(x):
        if mesh.index == 0:
            time.sleep(1.5)  # holds its turn past the other's timeout
        return mesh.psum(x)

    t0 = time.perf_counter()
    with pytest.raises(tmesh.ShardAborted):
        mesh.run(body, [torch.ones(1)] * 2)
    assert time.perf_counter() - t0 < 10.0


def test_collectives_follow_jax_semantics():
    """psum in rank order (bitwise repeatable), ppermute by (src, dst)
    pairs with zeros where no pair sends and (i, i) a local hand-back,
    all_gather stacked on a new axis 0 in rank order."""
    n = 4
    mesh = _analysis_mesh(n)
    xs = [torch.from_numpy(np.random.default_rng(i).normal(size=(3, 5))) for i in range(n)]

    def body(x):
        r = mesh.index
        return (mesh.psum(x), mesh.ppermute(x, [(0, 1), (1, 2), (3, 3)]),
                mesh.all_gather(x), r)

    out = mesh.run(body, xs)
    want = ((xs[0] + xs[1]) + xs[2]) + xs[3]
    for r, (s, p, g, idx) in enumerate(out):
        assert idx == r and torch.equal(s, want)
        src = {1: 0, 2: 1, 3: 3}.get(r)
        assert torch.equal(p, xs[src] if src is not None else torch.zeros(3, 5))
        assert torch.equal(g, torch.stack(xs))
    with pytest.raises(ValueError, match="permutation"):
        mesh.run(lambda x: mesh.ppermute(x, [(0, 1), (2, 1)]), xs)


def test_collectives_under_stress():
    """16 shards (more than the cores) through 200 alternating collectives
    with the interpreter switching threads every microsecond: every psum
    and ppermute still sees each shard's value of that very round."""
    n, rounds = 16, 200
    mesh = tmesh.ThreadMesh(n, "cpu", timeout=60.0)
    right = [(i, (i + 1) % n) for i in range(n)]

    def body(r0):
        bad = 0
        for k in range(rounds):
            v = torch.tensor([float(r0 * 1000 + k)])
            s = mesh.psum(v)
            bad += float(s) != sum(i * 1000 + k for i in range(n))
            got = mesh.ppermute(v, right)
            bad += float(got) != ((r0 - 1) % n) * 1000 + k
        return bad

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = []
        t = threading.Thread(target=lambda: out.extend(mesh.run(body, list(range(n)))))
        t.start()
        t.join(timeout=120.0)
        assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert out == [0] * n


def test_a_shards_grid_refuses_a_bare_analysis(tmp_path):
    """A shard's grid holds its own rows of the synthesis and projection
    but not the analysis: a bare call raises (the psum and the halo
    grids), while the step's analysis reaches the sharded one through
    EqContext.analysis."""
    model = port_model(jts._moist_rz_setup(tmp_path))
    grid, _, _ = tmodel.initialize(model, torch.float64, device="cpu")
    phys = torch.zeros((grid.nvars, grid.params.rDim // 4, grid.params.zDim),
                       dtype=torch.float64)
    for lg in (sh._local_grid(grid, 1, grid.params.rDim // 4), sh._window_grid(grid, 1, 4)):
        with pytest.raises(RuntimeError, match="analysis_fn"):
            lg.analysis(phys)
        assert lg.project(phys).shape[1] in (grid.params.b_rDim, grid.params.num_cells // 4 + 3)
