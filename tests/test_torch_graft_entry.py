"""The port's harness entry (scythe_tpu_torch/graft_entry.py) against
__graft_entry__.py, float64 on the CPU: entry()'s one flagship step equals
the JAX entry()'s at 1e-12; dryrun_multichip(2) runs one sharded step of
every group; the gradient of the 4D-Var cost through two sharded flagship
steps on a ThreadMesh of 2 and of 4 (psum, halo-gather, halo-pcr) equals
the one-device gradient at 1e-12 and jax.grad through the JAX package's
sharded step on the same inputs at 1e-9; and in a gloo world of one, a
backward through each DistMesh collective gives autograd's values (more
ranks: tests/test_torch_distmesh_grad.py).
"""

import importlib.util
import os
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
from scythe_tpu_torch import graft_entry as ge
from scythe_tpu_torch import model as tmodel
from scythe_tpu_torch.examples import cha_bell_initialization as cb
from scythe_tpu_torch.parallel import sharding as sh

torch.set_num_threads(2)
F64 = torch.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_spec = importlib.util.spec_from_file_location("graft_entry_jax",
                                               os.path.join(REPO, "__graft_entry__.py"))
jge = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jge)

CONFIGS = [("psum", "gather"), ("halo", "gather"), ("halo", "pcr")]


def test_entry_matches_jax(monkeypatch):
    import scythe_tpu.utils.runtime as jrt

    monkeypatch.setattr(jrt, "enable_compile_cache", lambda *a, **k: None)
    jfn, (jstate,) = jge.entry()
    fn, (state,) = ge.entry(F64, device="cpu")
    assert state.spec.device.type == "cpu" and state.spec.dtype == F64
    np.testing.assert_allclose(state.spec.numpy(), np.asarray(jstate.spec), rtol=0,
                               atol=1e-12 * float(np.abs(np.asarray(jstate.spec)).max()))
    ref = np.asarray(jax.jit(jfn)(jstate).spec)
    out = fn(state).spec.numpy()
    assert np.abs(out - ref).max() <= 1e-12 * np.abs(ref).max()


def test_dryrun_multichip_two_shards():
    done = ge.dryrun_multichip(2, F64, device="cpu")
    methods = ["psum", "halo/gather", "halo/pcr"]
    want = ([m for m in methods] + [m + "+filter" for m in methods]
            + [m + s for s in ("+tc-production/wishe+ivd+smag+sponge", "+slz-jw06/si+filter",
                               "+xyz-shower/diagnostic+filter", "+4dvar-grad")
               for m in methods] + ["ensemble"])
    assert done == want


def _flagship(n):
    model = cb.flagship_model(num_cells=4 * n, nl=16)
    grid = tx.create_grid(model.grid_params, F64, device="cpu")
    return model, grid, tmodel.build_context(model, grid, F64)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("method,interface", CONFIGS)
def test_sharded_4dvar_gradient_matches_one_device(n, method, interface):
    """The gradient with respect to the canonical spectral control: on the
    halo path through spec_to_blocks, the one-device cost summing the
    final state in the same windowed layout."""
    model, grid, ctx = _flagship(n)
    cl = grid.params.num_cells // n
    spec0 = cb.vortex_state(grid, F64).spec
    mesh = sh.make_mesh(n, device="cpu")
    sharded = ge.fourdvar_cost(model, grid, ctx, F64, mesh, method, interface)
    step = tmodel.build_step(model, grid, ctx, F64)

    def one_device(s):
        z = torch.zeros((grid.nvars,) + grid.spatial_shape, dtype=F64)
        spec = step(step(tx.timeintegration.ModelState(s, z, z, z, z, 1))).spec
        if method == "halo":
            spec = sh.spec_to_blocks(spec, n, cl)
        return 0.5 * torch.sum(spec * spec)

    grads, costs = [], []
    for fn in (lambda s: sharded(sh.spec_to_blocks(s, n, cl) if method == "halo" else s),
               one_device):
        s = spec0.detach().clone().requires_grad_(True)
        c = fn(s)
        grads.append(torch.autograd.grad(c, s)[0].numpy())
        costs.append(float(c.detach()))
    assert abs(costs[0] - costs[1]) <= 1e-12 * costs[1]
    assert np.abs(grads[0] - grads[1]).max() <= 1e-12 * np.abs(grads[1]).max()
    assert np.abs(grads[1]).max() > 0.0


@pytest.mark.parametrize("method,interface", CONFIGS)
def test_sharded_4dvar_gradient_matches_jax_grad(method, interface):
    """__graft_entry__.py:342-385 on 4 XLA host devices: jax.value_and_grad
    through the JAX package's sharded step, against the port's on a
    ThreadMesh of 4, from the same spectral control (in the method's
    layout), 1e-12 (the cost) and 1e-9 (the gradient)."""
    n = 4
    dtype = jnp.float64
    jmodel_ = jge._flagship_model(num_cells=4 * n, nl=16)
    jgrid = j_create_grid(jmodel_.grid_params, dtype)
    jctx = j_build_context(jmodel_, jgrid, dtype)
    jmesh = jsh.make_mesh(n)
    stepfn = jsh.build_sharded_step(jmodel_, jgrid, jctx, dtype, jmesh, method, interface)
    shape = (jgrid.nvars,) + jgrid.spatial_shape

    def cost(spec0):
        z = jnp.zeros(shape, dtype)
        st = stepfn(stepfn(jti.ModelState(spec0, z, z, z, z, jnp.asarray(1, jnp.int32))))
        return 0.5 * jnp.sum(st.spec * st.spec)

    gspec = jge._vortex_state(jgrid, dtype).spec
    if method == "halo":
        gspec = jsh.spec_to_blocks(gspec, n, jmodel_.grid_params.num_cells // n)
    from jax.sharding import NamedSharding

    gspec = jax.device_put(gspec, NamedSharding(jmesh, jsh.state_specs(method).spec))
    jval, jgrad = jax.jit(jax.value_and_grad(cost))(gspec)
    jgrad = np.asarray(jgrad)

    model, grid, ctx = _flagship(n)
    s = torch.from_numpy(np.array(gspec)).requires_grad_(True)
    c = ge.fourdvar_cost(model, grid, ctx, F64, sh.make_mesh(n, device="cpu"), method,
                         interface)(s)
    (g,) = torch.autograd.grad(c, s)
    assert abs(float(c.detach()) - float(jval)) <= 1e-12 * float(jval)
    assert np.abs(g.numpy() - jgrad).max() <= 1e-9 * np.abs(jgrad).max()


DIST = textwrap.dedent("""
    import os, sys
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    from scythe_tpu_torch.parallel import sharding as sh
    from scythe_tpu_torch.parallel.mesh import DistMesh
    dist.init_process_group("gloo", store=dist.FileStore(sys.argv[1], 1), rank=0,
                            world_size=1, timeout=timedelta(seconds=60))
    mesh = DistMesh(device="cpu")
    w = torch.tensor([0.5, -1.5, 2.0], dtype=torch.float64)
    plain = {"psum": lambda y: y, "all_gather": lambda y: y.unsqueeze(0),
             "ppermute": lambda y: y}
    coll = {"psum": mesh.psum, "all_gather": mesh.all_gather,
            "ppermute": lambda y: mesh.ppermute(y, [(0, 0)])}
    for name in ("psum", "all_gather", "ppermute"):
        x = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64, requires_grad=True)
        y = coll[name](x * x)
        assert torch.equal(y.detach(), plain[name](x * x).detach()), name
        (g,) = torch.autograd.grad((torch.cos(y) * w).sum(), x)
        (want,) = torch.autograd.grad((torch.cos(plain[name](x * x)) * w).sum(), x)
        print("GRAD", name, type(y.grad_fn).__name__, torch.equal(g, want), flush=True)
    x = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64, requires_grad=True)
    assert mesh.ppermute(x, [(0, 0)]) is x  # no communication: the identity
    (g,) = sh.replicated_grad((mesh.psum(x) ** 2).sum(), x, mesh)
    print("REPLICATED", torch.equal(g, 2.0 * x.detach()), flush=True)
    with torch.no_grad():
        assert not mesh.psum(x).requires_grad
    sys.stdout.flush()
    os._exit(0)
""")


def test_distmesh_backward_world_of_one(tmp_path):
    """A gloo world of one: psum, all_gather and a ppermute give their
    values, and a backward through each gives autograd's gradient of the
    same expression without the collective, bit for bit: psum and
    all_gather through their adjoint Functions (an all_reduce, a
    reduce-scatter), the (0, 0) ppermute as the identity; replicated_grad
    seeds the whole cotangent and sums over the one rank."""
    env = {**{k: v for k, v in os.environ.items() if not k.startswith("JAX_")},
           "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-c", DIST, str(tmp_path / "store")], env=env,
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split("\n")[:4] == [
        "GRAD psum _PsumFnBackward True", "GRAD all_gather _AllGatherFnBackward True",
        "GRAD ppermute MulBackward0 True", "REPLICATED True"], res.stdout
