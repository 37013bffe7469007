"""Gradients through a DistMesh: the sharded step differentiated over
torch.distributed, one gloo process a shard (a FileStore rendezvous, no
network), float64 on the CPU, against one device and against jax.grad.

Two spawns, of 2 and of 4 processes, run every case once (a module-scoped
fixture each test reads); every rank returns the whole gradient
(``sharding.replicated_grad``), and each test holds every rank's:

* the collectives alone: a replicated cost through psum, all_gather, a
  ring ppermute and an open ppermute (one pair: ranks that receive zeros,
  ranks that send nothing) against the same body on a ThreadMesh, whose
  collectives autograd differentiates itself (1e-13);
* the flagship's 4D-Var cost (``graft_entry.fourdvar_cost``, two sharded
  steps) by psum, halo/gather and halo/pcr, and the same cost with each
  step under ``torch.utils.checkpoint``, against one device (1e-12 of the
  gradient's max; the cost 1e-12), and halo/pcr on 2 ranks against
  ``jax.value_and_grad`` through the JAX package's sharded step on 2 XLA
  host devices (1e-9);
* the moist RZ semi-implicit step of tests/test_sharding.py (cloud and
  rain seeded everywhere: at exactly zero rain the warm-rain terms have no
  derivative, in both packages) for 5 steps, each under checkpoint, on 2
  ranks by psum and halo: the gradient with respect to the initial
  spectral state and to the replicated parameter K against one device
  (1e-12), and the column solve run 15 times a rank (5 forward, 5 in the
  recompute, 5 on M^T in the backward); the same on a ThreadMesh of 2,
  whose shard threads take the checkpoint's hooks;
* ``graft_entry.dryrun_multichip(2)`` on the two processes: every group,
  the 4D-Var gradient among them.

Every process group has a 60 s timeout and every spawn one of its own, so
a collective that one rank never joins fails the test rather than hang it.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scythe_tpu import create_grid as j_create_grid
from scythe_tpu import timeintegration as jti
from scythe_tpu.model import build_context as j_build_context
from scythe_tpu.parallel import sharding as jsh

import scythe_tpu_torch as tx
from scythe_tpu_torch import model as tmodel
from scythe_tpu_torch.examples import cha_bell_initialization as cb
from scythe_tpu_torch.parallel import mesh as pmesh
from scythe_tpu_torch.parallel import sharding as sh

import test_sharding as jts
from test_torch_graft_entry import jge
from test_torch_sharding import port_model

torch.set_num_threads(2)
F64 = torch.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [("psum", "gather"), ("halo", "gather"), ("halo", "pcr")]
MOIST_STEPS = 5
SPAWN_TIMEOUT = 300  # seconds for a whole spawn; a group's own timeout is 60

# The collectives' body, run by each rank of a DistMesh and by each shard
# of a ThreadMesh alike.
BODY = textwrap.dedent(
    """
    def collectives_cost(mesh, w, X):
        '''A replicated scalar of the replicated leaves w [k] and X [n, k]
        through every collective: psum, an open ppermute (the one pair
        (0, n - 1): the others receive zeros, and all but rank 0 send
        nothing), a ring ppermute, all_gather.'''
        n, r = mesh.size, mesh.index
        x = X[r] * w
        a = mesh.psum(x * x)
        b = mesh.ppermute(torch.sin(x), [(0, n - 1)])
        c = mesh.ppermute(x * a, [(i, (i + 1) % n) for i in range(n)])
        d = mesh.all_gather(x + b)
        return (a * w).sum() + (d ** 3).sum() + mesh.psum((c * x + b).sum())
    """
)

RANK = textwrap.dedent(
    """
    import faulthandler, os, pickle, sys
    from datetime import timedelta
    faulthandler.enable()  # a native abort prints where each thread was
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.modules["jax"] = None
    sys.modules["scythe_tpu"] = None
    torch.set_num_threads(1)
    rank, n, store, cfg_path, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                     sys.argv[4], sys.argv[5])
    dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank, world_size=n,
                            timeout=timedelta(seconds=60))
    import dataclasses
    from torch.utils.checkpoint import checkpoint
    import scythe_tpu_torch as tx
    from scythe_tpu_torch import graft_entry as ge
    from scythe_tpu_torch import model as tmodel
    from scythe_tpu_torch.examples import cha_bell_initialization as cb
    from scythe_tpu_torch.ops import column_solve as cs
    from scythe_tpu_torch.parallel import sharding as sh
    F64 = torch.float64
    with open(cfg_path, "rb") as f:
        cfg = pickle.load(f)
    exec(cfg["body"])
    mesh = sh.make_mesh(device="cpu")
    assert type(mesh).__name__ == "DistMesh" and mesh.size == n, mesh
    res = {}

    w = torch.from_numpy(cfg["w"]).requires_grad_(True)
    X = torch.from_numpy(cfg["X"][n]).requires_grad_(True)
    c = collectives_cost(mesh, w, X)
    res["collectives"] = (float(c), *(g.numpy() for g in sh.replicated_grad(c, (w, X), mesh)))

    model = cb.flagship_model(num_cells=4 * n, nl=16)
    grid = tx.create_grid(model.grid_params, F64, device="cpu")
    ctx = tmodel.build_context(model, grid, F64)
    cl = grid.params.num_cells // n
    spec0 = cb.vortex_state(grid, F64).spec

    def checkpointed_cost(method, interface):
        # fourdvar_cost with each step under checkpoint, composed as a user would
        step = sh.build_sharded_step(model, grid, ctx, F64, mesh, method, interface)

        def cost(s0):
            z = torch.zeros((grid.nvars,) + grid.spatial_shape, dtype=F64)
            st = sh.shard_state(tx.timeintegration.ModelState(s0, z, z, z, z, 1), mesh, method)
            for _ in range(2):
                st = checkpoint(step, st, use_reentrant=False)
            spec = sh.gather_global(st.spec)
            return 0.5 * torch.sum(spec * spec)

        return cost

    for method, interface in cfg["configs"]:
        for remat in (False, True):
            s = spec0.detach().clone().requires_grad_(True)
            cost = (checkpointed_cost(method, interface) if remat
                    else ge.fourdvar_cost(model, grid, ctx, F64, mesh, method, interface))
            c = cost(sh.spec_to_blocks(s, n, cl) if method == "halo" else s)
            (g,) = sh.replicated_grad(c, s, mesh)
            res["fourdvar", method, interface, remat] = (float(c), g.numpy())

    if n == 2:
        # the harness entry's every group, the 4D-Var gradient among them
        res["dryrun"] = ge.dryrun_multichip(n, F64, device="cpu")
        # the JAX case: the control in the halo layout itself
        b = torch.from_numpy(cfg["jax_blocks"]).requires_grad_(True)
        c = ge.fourdvar_cost(model, grid, ctx, F64, mesh, "halo", "pcr")(b)
        res["jax"] = (float(c), sh.replicated_grad(c, b, mesh)[0].numpy())

        calls = []
        plain = cs.apply_column_operator_plain

        def counted(*a, **k):
            calls.append(1)
            return plain(*a, **k)

        cs.apply_column_operator_plain = counted
        mgrid, mctx, state = tmodel.initialize(cfg["moist"], F64, device="cpu")
        mcl = mgrid.params.num_cells // n
        for method in ("psum", "halo"):
            K = torch.tensor(cfg["moist"].phys()["K"], dtype=F64, requires_grad=True)
            kctx = dataclasses.replace(mctx, params={**mctx.params, "K": K})
            step = sh.build_sharded_step(cfg["moist"], mgrid, kctx, F64, mesh, method)
            s = state.spec.detach().clone().requires_grad_(True)
            st = state._replace(spec=sh.spec_to_blocks(s, n, mcl) if method == "halo" else s)
            st = sh.shard_state(st, mesh, method)
            calls.clear()
            for _ in range(cfg["moist_steps"]):
                st = checkpoint(step, st, use_reentrant=False)
            spec = sh.gather_global(st.spec)
            if method == "halo":
                spec = sh.blocks_to_spec(spec, n, mcl)
            c = 0.5 * torch.sum(spec * spec)
            gs, gk = sh.replicated_grad(c, (s, K), mesh)
            res["moist", method] = (float(c), gs.numpy(), float(gk), len(calls))

    with open(out, "wb") as f:
        pickle.dump(res, f)
    dist.barrier()  # neither rank tears its connections down while the other uses them
    dist.destroy_process_group()
    # leave without the interpreter's teardown, where a gloo rank can abort
    # after its work (tools/torch_gloo_teardown_check.py)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
    """
)


def _moist_model(tmp_path):
    """tests/test_sharding.py's moist RZ setup, as the port's model, with
    cloud and rain 1e-4 everywhere in its initial conditions."""
    model = port_model(jts._moist_rz_setup(tmp_path))
    with open(model.initial_conditions) as f:
        header = f.readline().strip().split(",")
    cols = np.loadtxt(model.initial_conditions, delimiter=",", skiprows=1)
    cols[:, header.index("mu_c")] = cols[:, header.index("mu_r")] = 1.0e-4
    np.savetxt(model.initial_conditions, cols, delimiter=",", header=",".join(header),
               comments="")
    return model


def _jax_blocks(n):
    """The flagship's vortex spectral state in the halo layout of ``n``
    shards, as the JAX package makes it."""
    jmodel = jge._flagship_model(num_cells=4 * n, nl=16)
    jgrid = j_create_grid(jmodel.grid_params, jnp.float64)
    gspec = jge._vortex_state(jgrid, jnp.float64).spec
    return np.array(jsh.spec_to_blocks(gspec, n, jmodel.grid_params.num_cells // n))


def _spawn(n, tmp):
    """Start ``n`` rank processes of RANK; returns (procs, outputs)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
    env["PYTHONPATH"] = REPO
    outs = [str(tmp / f"rank{r}.pkl") for r in range(n)]
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), str(n), str(tmp / "store"),
                               str(tmp / "cfg.pkl"), outs[r]], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(n)]
    return procs, outs


def _collect(procs, outs):
    """Every rank's results, once all have ended (killed past the timeout)."""
    try:
        ended = [p.communicate(timeout=SPAWN_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, ended)):
        assert p.returncode == 0, f"rank {r} of {len(procs)}: {err[-3000:]}"
    res = []
    for path in outs:
        with open(path, "rb") as f:
            res.append(pickle.load(f))
    return res


@pytest.fixture(scope="module")
def moist_model(tmp_path_factory):
    return _moist_model(tmp_path_factory.mktemp("moist"))


@pytest.fixture(scope="module")
def collective_inputs():
    rng = np.random.default_rng(13)
    return rng.normal(size=5), {n: rng.normal(size=(n, 5)) for n in (2, 4)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, moist_model, collective_inputs):
    """{n: [rank 0's results, ...]} of the spawns of 2 and 4 processes, run
    side by side."""
    w, X = collective_inputs
    running = {}
    for n in (2, 4):
        tmp = tmp_path_factory.mktemp(f"dist{n}")
        with open(tmp / "cfg.pkl", "wb") as f:
            pickle.dump({"body": BODY, "w": w, "X": X, "configs": CONFIGS,
                         "jax_blocks": _jax_blocks(2), "moist": moist_model,
                         "moist_steps": MOIST_STEPS}, f)
        running[n] = _spawn(n, tmp)
    return {n: _collect(*running[n]) for n in (2, 4)}


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_backward_match_a_threadmesh(ranks, collective_inputs, n):
    """psum, all_gather and both ppermutes over gloo give every rank the
    gradient a ThreadMesh's autograd gives, of the cost and of both leaves."""
    ns = {"torch": torch}
    exec(BODY, ns)
    w_np, X_np = collective_inputs
    w = torch.from_numpy(w_np).requires_grad_(True)
    X = torch.from_numpy(X_np[n]).requires_grad_(True)
    mesh = pmesh.ThreadMesh(n, "cpu")
    costs = mesh.run(lambda _: ns["collectives_cost"](mesh, w, X), [None] * n)
    gw, gX = torch.autograd.grad(costs[0], (w, X))
    for r, res in enumerate(ranks[n]):
        c, dw, dX = res["collectives"]
        c0 = float(costs[0].detach())
        assert abs(c - c0) <= 1e-13 * abs(c0), (r, c, c0)
        assert _rel(dw, gw.numpy()) <= 1e-13, (r, _rel(dw, gw.numpy()))
        assert _rel(dX, gX.numpy()) <= 1e-13, (r, _rel(dX, gX.numpy()))


def _one_device_fourdvar(n, method):
    """(cost, gradient) of the 4D-Var cost on one device, from the canonical
    control, the final state summed in ``method``'s layout."""
    model = cb.flagship_model(num_cells=4 * n, nl=16)
    grid = tx.create_grid(model.grid_params, F64, device="cpu")
    step = tmodel.build_step(model, grid, tmodel.build_context(model, grid, F64), F64)
    s = cb.vortex_state(grid, F64).spec.detach().clone().requires_grad_(True)
    z = torch.zeros((grid.nvars,) + grid.spatial_shape, dtype=F64)
    spec = step(step(tx.timeintegration.ModelState(s, z, z, z, z, 1))).spec
    if method == "halo":
        spec = sh.spec_to_blocks(spec, n, grid.params.num_cells // n)
    c = 0.5 * torch.sum(spec * spec)
    return float(c), torch.autograd.grad(c, s)[0].numpy()


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "checkpoint"])
@pytest.mark.parametrize("method,interface", CONFIGS)
@pytest.mark.parametrize("n", [2, 4])
def test_fourdvar_gradient_matches_one_device(ranks, n, method, interface, remat):
    """The gradient of graft_entry.fourdvar_cost through two sharded
    flagship steps, on every rank, equals the one-device gradient at 1e-12
    of its max; the cost at 1e-12."""
    c1, g1 = _one_device_fourdvar(n, method)
    assert np.abs(g1).max() > 0.0
    for r, res in enumerate(ranks[n]):
        c, g = res["fourdvar", method, interface, remat]
        assert abs(c - c1) <= 1e-12 * c1, (r, c, c1)
        assert _rel(g, g1) <= 1e-12, (r, _rel(g, g1))


def test_fourdvar_gradient_matches_jax_grad(ranks):
    """__graft_entry__.py:342-385 on 2 XLA host devices by halo/pcr (at 2
    shards both levels' ppermutes join the same two ranks, so their
    adjoints must run in one order on both): jax.value_and_grad through the
    JAX package's sharded step against the port's on a DistMesh of 2 gloo
    processes, from the same control in the halo layout, 1e-12 (the cost)
    and 1e-9 (the gradient, on each rank)."""
    n = 2
    jmodel = jge._flagship_model(num_cells=4 * n, nl=16)
    jgrid = j_create_grid(jmodel.grid_params, jnp.float64)
    jmesh = jsh.make_mesh(n)
    stepfn = jsh.build_sharded_step(jmodel, jgrid, j_build_context(jmodel, jgrid, jnp.float64),
                                    jnp.float64, jmesh, "halo", "pcr")
    shape = (jgrid.nvars,) + jgrid.spatial_shape

    def cost(spec0):
        z = jnp.zeros(shape, jnp.float64)
        st = stepfn(stepfn(jti.ModelState(spec0, z, z, z, z, jnp.asarray(1, jnp.int32))))
        return 0.5 * jnp.sum(st.spec * st.spec)

    from jax.sharding import NamedSharding

    gspec = jax.device_put(jnp.asarray(_jax_blocks(n)),
                           NamedSharding(jmesh, jsh.state_specs("halo").spec))
    jval, jgrad = jax.jit(jax.value_and_grad(cost))(gspec)
    jgrad = np.asarray(jgrad)
    for r, res in enumerate(ranks[n]):
        c, g = res["jax"]
        assert abs(c - float(jval)) <= 1e-12 * float(jval), (r, c, float(jval))
        assert _rel(g, jgrad) <= 1e-9, (r, _rel(g, jgrad))


def test_dryrun_multichip_on_two_processes(ranks):
    """graft_entry.dryrun_multichip(2) under an initialised gloo group runs
    every group on the DistMesh of the two processes, the 4D-Var gradient
    by psum, halo/gather and halo/pcr among them, as on a ThreadMesh
    (test_torch_graft_entry.py::test_dryrun_multichip_two_shards)."""
    methods = ["psum", "halo/gather", "halo/pcr"]
    want = (methods + [m + "+filter" for m in methods]
            + [m + s for s in ("+tc-production/wishe+ivd+smag+sponge", "+slz-jw06/si+filter",
                               "+xyz-shower/diagnostic+filter", "+4dvar-grad")
               for m in methods] + ["ensemble"])
    for r, res in enumerate(ranks[2]):
        assert res["dryrun"] == want, (r, res["dryrun"])


@pytest.fixture(scope="module")
def moist_one_device(moist_model):
    """(cost, d/dspec0, d/dK) of the moist cost on one device."""
    import dataclasses

    grid, ctx, state = tmodel.initialize(moist_model, F64, device="cpu")
    K = torch.tensor(moist_model.phys()["K"], dtype=F64, requires_grad=True)
    step = tmodel.build_step(moist_model, grid,
                             dataclasses.replace(ctx, params={**ctx.params, "K": K}), F64)
    s = state.spec.detach().clone().requires_grad_(True)
    st = state._replace(spec=s)
    for _ in range(MOIST_STEPS):
        st = step(st)
    c = 0.5 * torch.sum(st.spec * st.spec)
    gs, gk = torch.autograd.grad(c, (s, K))
    return float(c), gs.numpy(), float(gk)


@pytest.mark.parametrize("method", ["psum", "halo"])
def test_moist_si_gradient_matches_one_device(ranks, moist_one_device, method):
    """Checkpointed semi-implicit moist RZ steps on a DistMesh of 2: the
    gradient with respect to the initial spectral state, on each rank,
    equals one device's at 1e-12 of its max, and each rank ran its column
    solve 3 times a step (forward, recompute, backward on M^T)."""
    c1, g1, _ = moist_one_device
    assert np.isfinite(g1).all() and np.abs(g1).max() > 0.0
    for r, res in enumerate(ranks[2]):
        c, g, _, solves = res["moist", method]
        assert abs(c - c1) <= 1e-12 * c1, (r, c, c1)
        assert _rel(g, g1) <= 1e-12, (r, _rel(g, g1))
        assert solves == 3 * MOIST_STEPS, (r, solves)


@pytest.mark.parametrize("method", ["psum", "halo"])
def test_replicated_parameter_gradient_matches_one_device(ranks, moist_one_device, method):
    """The gradient with respect to K, a parameter every shard's step reads
    (replicated: each rank's share summed by replicated_grad), on each rank
    equals one device's at 1e-12."""
    _, _, k1 = moist_one_device
    assert k1 != 0.0
    for r, res in enumerate(ranks[2]):
        k = res["moist", method][2]
        assert abs(k - k1) <= 1e-12 * abs(k1), (r, k, k1)


@pytest.mark.parametrize("method", ["psum", "halo"])
def test_checkpoint_recomputes_on_a_threadmesh(moist_model, moist_one_device, method,
                                               monkeypatch):
    """The same checkpointed steps on a ThreadMesh of 2: its shards run in
    threads of their own, which take the caller's saved-tensor hooks
    (sharding._under_callers_hooks), so each shard's activations are dropped
    and recomputed as on a DistMesh (3 column solves a shard a step, not
    2), and the gradients equal one device's at 1e-12."""
    import dataclasses

    from scythe_tpu_torch.ops import column_solve as cs
    from torch.utils.checkpoint import checkpoint

    calls = []
    plain = cs.apply_column_operator_plain

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(cs, "apply_column_operator_plain", counted)
    n = 2
    grid, ctx, state = tmodel.initialize(moist_model, F64, device="cpu")
    K = torch.tensor(moist_model.phys()["K"], dtype=F64, requires_grad=True)
    mesh = sh.make_mesh(n, device="cpu")
    step = sh.build_sharded_step(moist_model, grid,
                                 dataclasses.replace(ctx, params={**ctx.params, "K": K}),
                                 F64, mesh, method)
    cl = grid.params.num_cells // n
    s = state.spec.detach().clone().requires_grad_(True)
    st = sh.shard_state(state._replace(spec=sh.spec_to_blocks(s, n, cl) if method == "halo"
                                       else s), mesh, method)
    for _ in range(MOIST_STEPS):
        st = checkpoint(step, st, use_reentrant=False)
    spec = sh.gather_global(st.spec)
    if method == "halo":
        spec = sh.blocks_to_spec(spec, n, cl)
    gs, gk = sh.replicated_grad(0.5 * torch.sum(spec * spec), (s, K), mesh)
    assert len(calls) == n * 3 * MOIST_STEPS, len(calls)
    _, g1, k1 = moist_one_device
    assert _rel(gs.numpy(), g1) <= 1e-12, _rel(gs.numpy(), g1)
    assert abs(float(gk) - k1) <= 1e-12 * abs(k1), (float(gk), k1)
