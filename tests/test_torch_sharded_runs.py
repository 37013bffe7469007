"""Sharded runs of the port on the other geometries, through integrate_sharded
and over torch.distributed.

Float64 on the CPU.  The geometry gates of the JAX tests on 4 thread-shards:
the SL sphere (tests/test_sphere.py:119, Williamson 6 for 40 steps, psum
and halo, 1e-11 of the state's max), the SLZ shell (tests/test_slz.py:173,
30 steps, psum, 1e-11) and the XYZ box (tests/test_xyz.py:190, 20 steps,
psum and halo, 1e-12 of the fields' max); the SLZ shell with del^4
hyperdiffusion, whose refit goes through the step's sharded transforms
(1e-12) and whose stability guard sees the whole grid; integrate_sharded checkpointed and resumed against the
continuous single-device run (tests/test_resume.py:65, 1e-13), and across
layouts; the ensemble mesh (tests/test_jax_native.py:109, 8 shards,
1e-13); and a DistMesh of two gloo processes, by psum and by halo, against
one device (1e-12).
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import scythe_tpu_torch as tx
from scythe_tpu_torch import model as tmodel
from scythe_tpu_torch import timeintegration as tti
from scythe_tpu_torch.examples import williamson_sphere as twm
from scythe_tpu_torch.parallel import sharding as sh

import test_jax_native as jjn
import test_resume as jres
import test_sharding as jts
import test_torch_slz as tslz
import test_xyz as jxyz
from test_torch_sharding import port_model, port_params

torch.set_num_threads(2)
F64 = torch.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_sharded(model, grid, ctx, state0, n, method, n_steps):
    """The whole canonical spectral state after ``n_steps`` of the sharded
    step built on the single-device grid and context, as the JAX geometry
    tests run it."""
    mesh = sh.make_mesh(n, device="cpu")
    cl = grid.params.num_cells // n
    st = state0
    if method == "halo":
        st = st._replace(spec=sh.spec_to_blocks(st.spec, n, cl))
    step = sh.build_sharded_step(model, grid, ctx, F64, mesh, method)
    spec = sh.gather_global(tmodel.make_scan(step, n_steps)(sh.shard_state(st, mesh, method))
                            .spec)
    return sh.blocks_to_spec(spec, n, cl) if method == "halo" else spec


def _single(model, grid, ctx, state0, n_steps):
    return tmodel.make_scan(tmodel.build_step(model, grid, ctx, F64), n_steps)(state0).spec


@pytest.mark.parametrize("method", ["psum", "halo"])
def test_sl_sharding_invariance(method):
    """Latitude decomposition on the sphere (Williamson 6 at ts 150 s)."""
    model = twm.build_model(ts=150.0)
    grid = tx.create_grid(model.grid_params, F64, device="cpu")
    ctx = tmodel.build_context(model, grid, F64)
    pts = grid.gridpoints()
    phi = pts[:, 0].reshape(grid.spatial_shape)
    lam = pts[:, 1].reshape(grid.spatial_shape)
    spec0 = grid.analysis(torch.from_numpy(np.stack(twm.w6_fields(phi, lam))))
    state0 = tti.initial_state(spec0, (3,) + grid.spatial_shape, F64)
    ref = _single(model, grid, ctx, state0, 40).numpy()
    spec = _run_sharded(model, grid, ctx, state0, 4, method, 40).numpy()
    assert np.abs(spec - ref).max() < 1e-11 * np.abs(ref).max()


def _slz_bubble(model, tmp_path):
    grid, ctx = tslz._port(model)
    pts = grid.gridpoints()
    phi = pts[:, 0].reshape(grid.spatial_shape)
    z = pts[:, 2].reshape(grid.spatial_shape)
    rad = np.sqrt(((phi - np.pi / 6) / 0.12) ** 2 + ((z - 1500.0) / 1500.0) ** 2)
    phys0 = np.zeros((grid.nvars,) + grid.spatial_shape)
    phys0[0] = 10.0 * np.maximum(0.0, np.cos(np.pi * np.minimum(rad, 1.0) / 2.0)) ** 2
    spec0 = grid.analysis(torch.from_numpy(phys0))
    return grid, ctx, tti.initial_state(spec0, (grid.nvars,) + grid.spatial_shape, F64)


def test_slz_sharding_invariance(tmp_path):
    """Latitude decomposition of the global 3-D core, psum."""
    model = tslz._model(tmp_path)
    grid, ctx, state0 = _slz_bubble(model, tmp_path)
    ref = _single(model, grid, ctx, state0, 30).numpy()
    spec = _run_sharded(model, grid, ctx, state0, 4, "psum", 30).numpy()
    assert np.abs(spec - ref).max() < 1e-11 * np.abs(ref).max()


@pytest.mark.parametrize("method,n", [("psum", 4), ("halo", 3)])
def test_slz_hyperdiffusion_refit_sharded(tmp_path, method, n):
    """MoistEulerSLZ with options['hyperdiffusion_k4']: the second Laplacian
    comes from refitting the first, which on a shard must go through the
    step's sharded analysis and the shard's synthesis (a shard's grid
    cannot analyse).  Sharded equals one device at 1e-12 of the state's
    max after 20 steps, and the del^4 term moved the state by far more.
    The halo run takes 3 shards (4 cells each, the Schur path's least)."""
    model = tslz._model(tmp_path)
    model = model.with_(options={**model.opts(), "hyperdiffusion_k4": 2.0e20})
    grid, ctx, state0 = _slz_bubble(model, tmp_path)
    ref = _single(model, grid, ctx, state0, 20).numpy()
    spec = _run_sharded(model, grid, ctx, state0, n, method, 20).numpy()
    assert np.abs(spec - ref).max() < 1e-12 * np.abs(ref).max()
    plain = tslz._model(tmp_path)
    g0, c0, s0 = _slz_bubble(plain, tmp_path)
    without = _single(plain, g0, c0, s0, 20).numpy()
    assert np.abs(without - ref).max() > 1e-6 * np.abs(ref).max()


def test_slz_hyperdiffusion_guard_sees_the_whole_grid(tmp_path):
    """The del^4 stability guard takes the meridional spacing of the whole
    grid: a K4 one device refuses (diagonal CFL about 1 at 12 cells, ts
    0.25 s) is refused on 4 shards too, where a shard's 9 rows would give a
    spacing 4x as wide and a CFL 256x as small."""
    model = tslz._model(tmp_path)
    model = model.with_(options={**model.opts(), "hyperdiffusion_k4": 1.0e21})
    grid, ctx, state0 = _slz_bubble(model, tmp_path)
    with pytest.raises(ValueError, match="hyperdiffusion_k4"):
        _single(model, grid, ctx, state0, 1)
    with pytest.raises(ValueError, match="hyperdiffusion_k4"):
        _run_sharded(model, grid, ctx, state0, 4, "psum", 1)


@pytest.mark.parametrize("method", ["psum", "halo"])
def test_xyz_sharding_invariance(tmp_path, method):
    """The x decomposition of the XYZ box (16 cells: 4 a shard, the halo
    path's least), MoistEulerXYZ 20 steps, on the synthesised fields."""
    jgp = jxyz.GridParameters(
        geometry="XYZ", xmin=0.0, xmax=16000.0, num_cells=16, lDim=16, ymin=0.0,
        ymax=jxyz.LY, zmin=0.0, zmax=jxyz.LZ, zDim=16,
        BCL={"u": jxyz.BC.R1T0, "w": jxyz.BC.R1T1}, BCR={"u": jxyz.BC.R1T0},
        vars=jxyz.XYZ_VARS,
    )
    jm = jxyz._model(tmp_path, jgp, "MoistEulerXYZ", "shard.csv")
    model = port_model(jm).with_(grid_params=port_params(jgp))
    grid = tx.create_grid(model.grid_params, F64, device="cpu")
    pts = grid.gridpoints()
    x, y, z = (pts[:, i].reshape(grid.spatial_shape) for i in range(3))
    phys0 = np.zeros((grid.nvars,) + grid.spatial_shape)
    phys0[0] = jxyz._bubble_s(x, z) * (1.0 + 0.3 * np.sin(2.0 * np.pi * y / jxyz.LY))
    ctx = tmodel.build_context(model, grid, F64)
    state0 = tti.initial_state(grid.analysis(torch.from_numpy(phys0)),
                               (grid.nvars,) + grid.spatial_shape, F64)
    ref = grid.synthesis(_single(model, grid, ctx, state0, 20))["val"].numpy()
    got = grid.synthesis(_run_sharded(model, grid, ctx, state0, 4, method, 20))["val"].numpy()
    assert np.abs(got - ref).max() < 1e-12 * np.abs(ref).max()


def _resume_model(tmp_path, T, outdir, options=()):
    return port_model(jres._model(tmp_path, T, outdir, options))


@pytest.mark.parametrize("method", ["psum", "halo"])
def test_sharded_resume_matches_continuous(tmp_path, method):
    """integrate_sharded on 4 shards, checkpointed and resumed, continues
    the single-device trajectory (1e-13), with its log and
    checkpoint files."""
    full = _resume_model(tmp_path, 20.0, f"full_{method}")
    _, phys_full = tmodel.integrate_model(full, F64, write_outputs=False, device="cpu")
    first = _resume_model(tmp_path, 10.0, f"first_{method}", {"checkpoint_interval": 10.0})
    sh.integrate_sharded(first, 4, F64, method=method, device="cpu")
    ckpt = os.path.join(first.output_dir, "checkpoint_10.0.npz")
    assert os.path.exists(ckpt)
    assert os.path.exists(os.path.join(first.output_dir, "scythe_out.log"))
    assert os.path.exists(os.path.join(first.output_dir, "physical_out_5.0.csv"))
    second = _resume_model(tmp_path, 10.0, f"second_{method}")
    _, phys = sh.integrate_sharded(second, 4, F64, method=method, resume_from=ckpt,
                                   device="cpu")
    np.testing.assert_allclose(phys, phys_full, rtol=0, atol=1e-13)
    assert os.path.exists(os.path.join(second.output_dir, "physical_out_20.0.csv"))


def test_resume_crosses_layouts(tmp_path):
    """Checkpoints are canonical: a single-device checkpoint resumes on 4
    halo shards, and a halo checkpoint on one device, both on the
    continuous trajectory (1e-13)."""
    full = _resume_model(tmp_path, 20.0, "full")
    _, phys_full = tmodel.integrate_model(full, F64, write_outputs=False, device="cpu")
    one = _resume_model(tmp_path, 10.0, "one", {"checkpoint_interval": 10.0})
    tmodel.integrate_model(one, F64, device="cpu")
    halo = _resume_model(tmp_path, 10.0, "halo", {"checkpoint_interval": 10.0})
    sh.integrate_sharded(halo, 4, F64, method="halo", device="cpu")
    for ckpt, resume in (
        (os.path.join(one.output_dir, "checkpoint_10.0.npz"),
         lambda m, c: sh.integrate_sharded(m, 4, F64, method="halo", resume_from=c,
                                           device="cpu")),
        (os.path.join(halo.output_dir, "checkpoint_10.0.npz"),
         lambda m, c: tmodel.integrate_model(m, F64, resume_from=c, device="cpu")),
    ):
        _, phys = resume(_resume_model(tmp_path, 10.0, "second"), ckpt)
        np.testing.assert_allclose(phys, phys_full, rtol=0, atol=1e-13)


def test_integrate_ensemble_sharded_matches_single(tmp_path):
    """Members as the shards of an ensemble mesh (8 thread-shards): equal to
    the unsharded ensemble member for member (1e-13); a member count the
    mesh does not divide raises."""
    jm, jgrid, _ = jjn._advection()
    model = port_model(jm).with_(integration_time=1.0)
    r = np.asarray(jgrid.r_mish)
    shifts = np.linspace(-7.0, 7.0, 8)
    ics = np.exp(-(((r[None, None, :] - shifts[:, None, None]) / 15.0) ** 2))
    _, ref = tmodel.integrate_ensemble(model, ics, dtype=F64, device="cpu")
    mesh = sh.make_ensemble_mesh(8, device="cpu")
    _, out = tmodel.integrate_ensemble(model, ics, dtype=F64, mesh=mesh, device="cpu")
    np.testing.assert_allclose(out, ref, atol=1e-13)
    with pytest.raises(ValueError, match="divisible"):
        tmodel.integrate_ensemble(model, ics[:3], dtype=F64, mesh=mesh, device="cpu")


GLOO_RANK = textwrap.dedent(
    """
    import faulthandler, os, pickle, sys
    faulthandler.enable()  # a native abort prints where each thread was
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.modules["jax"] = None
    sys.modules["scythe_tpu"] = None
    torch.set_num_threads(1)
    rank, store, cfg, method, out = sys.argv[1:6]
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=int(rank),
                            world_size=2)
    from scythe_tpu_torch.parallel import sharding as sh
    with open(cfg, "rb") as f:
        model = pickle.load(f)
    mesh = sh.make_mesh(device="cpu")
    assert type(mesh).__name__ == "DistMesh" and mesh.size == 2, mesh
    _, phys = sh.integrate_sharded(model, 2, torch.float64, method=method, device="cpu")
    if rank == "0":
        np.save(out, phys)
    dist.barrier()  # neither rank tears its connections down while the other uses them
    dist.destroy_process_group()
    # Leave without the interpreter's teardown, where a gloo rank can abort
    # after its work is done ("terminate called without an active
    # exception", no Python frame), with or without the group destroyed
    # first (tools/torch_gloo_teardown_check.py).
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
    """
)


def _spawn_ranks(script, args_of, n, cwd=REPO):
    """Run ``script`` in ``n`` processes (``args_of(rank)`` each) and return
    their (returncode, stderr)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen([sys.executable, "-c", script, *args_of(r)], cwd=cwd, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(n)]
    try:
        results = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    return [(p.returncode, err) for p, (_, err) in zip(procs, results)]


@pytest.mark.parametrize("method", ["psum", "halo"])
def test_two_gloo_processes_match_one_device(tmp_path, method):
    """A DistMesh of two processes over gloo (a FileStore rendezvous, no
    network), the moist RZ setup of tests/test_sharding.py through
    integrate_sharded for 10 steps with spectral outputs on: rank 0's result
    equals one device at 1e-12 (gloo's reduction order is its own, so not
    bitwise), and rank 0 writes the log and every spectral output (each a
    gather that both ranks join)."""
    model = port_model(jts._moist_rz_setup(tmp_path), write_spectral=True)
    cfg = tmp_path / "model.pkl"
    with open(cfg, "wb") as f:
        pickle.dump(model.with_(output_dir=str(tmp_path / "out_gloo")), f)
    out = tmp_path / "phys.npy"
    store = tmp_path / "store"
    results = _spawn_ranks(GLOO_RANK, lambda r: [str(r), str(store), str(cfg), method, str(out)],
                           2)
    for r, (rc, err) in enumerate(results):
        assert rc == 0, f"rank {r}: {err[-3000:]}"
    _, want = tmodel.integrate_model(model, F64, write_outputs=False, device="cpu")
    got = np.load(out)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    written = sorted(os.listdir(tmp_path / "out_gloo"))
    assert "scythe_out.log" in written
    n_out = int(round(model.integration_time / model.output_interval)) + 1
    assert sum(f.startswith("spectral_out_") for f in written) == n_out, written


GLOO_WORLD_OF_ONE = textwrap.dedent(
    """
    import os, sys
    import torch
    import torch.distributed as dist
    sys.modules["jax"] = None
    sys.modules["scythe_tpu"] = None
    dist.init_process_group("gloo", store=dist.FileStore(sys.argv[1], 1), rank=0,
                            world_size=1)
    from scythe_tpu_torch.parallel import mesh as pmesh
    for make in (pmesh.make_mesh, pmesh.make_ensemble_mesh, pmesh.DistMesh):
        try:
            m = make()
        except (RuntimeError, ValueError) as e:  # no card / a gloo group on the card
            print(type(e).__name__, str(e).replace(chr(10), " "))
        else:
            print("MESH", m, m.device_of(0))
    m = pmesh.make_mesh(device="cpu")
    print("CPU", type(m).__name__, m.size, m.device_of(0))
    try:
        pmesh.make_mesh(2, device="cpu")
    except ValueError as e:
        print("SIZE", e)
    dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
    """
)


def test_gloo_mesh_takes_no_cpu_by_default(tmp_path):
    """With a gloo group initialised (a world of one), make_mesh,
    make_ensemble_mesh and DistMesh at their default device raise, with a
    card as without one, rather than put the run on the CPU; with
    device="cpu" the mesh is the group's, and a shard count other than the
    group's size raises."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", GLOO_WORLD_OF_ONE, str(tmp_path / "store")],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert not any(ln.startswith("MESH") for ln in lines), lines
    want = "ValueError" if torch.cuda.is_available() else "RuntimeError"
    assert [ln.split()[0] for ln in lines[:3]] == [want] * 3, lines
    if want == "ValueError":
        assert all("device='cpu'" in ln for ln in lines[:3]), lines
    assert lines[3] == "CPU DistMesh 1 cpu", lines
    assert lines[4].startswith("SIZE 2 shards asked of a torch.distributed group of 1"), lines
