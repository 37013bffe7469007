"""Harness entry points, the port of ``__graft_entry__.py``.

``entry()``             -> (step, (state,)): one step of the flagship model
                           (Twoway_ShallowWater_Slab, the Cha & Bell 2024
                           two-layer TC configuration, at 32 cells x 32) on
                           the card unless the caller asks for the CPU.
``dryrun_multichip(n)`` -> runs ONE radially sharded step of each group
                           on a mesh of n shards (a ``ThreadMesh``, or a
                           ``DistMesh`` where a torch.distributed group is
                           initialised, as under ``jax.distributed``; the
                           gradient too): the flagship by
                           psum, halo-gather and halo-pcr, each with and
                           without the modal filter; the RLZ moist core
                           with the TC production options; the SLZ shell
                           with the JW06 options; the XYZ shower bundle;
                           the gradient of a 4D-Var cost through two
                           sharded steps; and members as the mesh axis.

The flagship configuration and its vortex are
``examples/cha_bell_initialization.py``'s ``flagship_model``,
``vortex_phys`` and ``vortex_state`` (the JAX file's ``_flagship_model``,
``_vortex_phys`` and ``_vortex_state``).

Run:  python -m scythe_tpu_torch.graft_entry [--cpu]
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from . import BC, ZBC, GridParameters, ModelParameters, create_grid
from . import timeintegration as ti
from .device import DEFAULT
from .examples import cha_bell_initialization as cb
from .model import _set_boundary_refs, build_context, build_step, imp_history_rows
from .parallel import sharding as sh


def entry(dtype=None, device=DEFAULT):
    """One forward step of the flagship model and its argument: the vortex
    state on ``device`` in ``dtype`` (the default dtype unless given)."""
    dtype = dtype or torch.get_default_dtype()
    model = cb.flagship_model()
    grid = create_grid(model.grid_params, dtype, device=device)
    step = build_step(model, grid, build_context(model, grid, dtype), dtype)
    return step, (cb.vortex_state(grid, dtype),)


def fourdvar_cost(model, grid, ctx, dtype, mesh=None, method="psum", interface="auto",
                  n_steps=2):
    """cost(spec0) = 0.5 ||spec after ``n_steps``||^2 from the spectral
    control ``spec0`` with zero tendency histories at t = 1, the structure
    examples/assimilate_4dvar.py optimizes.  On a ``mesh`` (``sh.make_mesh``:
    threads of this process, or the ranks of an initialised torch.distributed
    group) the steps are the sharded step of ``method`` / ``interface`` and
    ``spec0`` is in that method's layout (windowed blocks on "halo",
    ``sh.spec_to_blocks``), as is the spec the cost sums.  The cost is
    replicated: differentiate it by ``sh.replicated_grad(cost, spec0,
    mesh)``, which gives every rank the whole gradient (each step may go
    under ``torch.utils.checkpoint(step, st, use_reentrant=False)`` as it
    does on one device)."""
    if mesh is None:
        step = build_step(model, grid, ctx, dtype)
    else:
        step = sh.build_sharded_step(model, grid, ctx, dtype, mesh, method, interface)
    shape = (grid.nvars,) + grid.spatial_shape

    def cost(spec0):
        z = torch.zeros(shape, dtype=dtype, device=spec0.device)
        st = ti.ModelState(spec0, z, z, z, z, 1)
        if mesh is not None:
            st = sh.shard_state(st, mesh, method)
        for _ in range(n_steps):
            st = step(st)
        spec = sh.gather_global(st.spec)
        return 0.5 * torch.sum(spec * spec)

    return cost


def _rlz_tc_model(tdir, cells):
    """The 3-D moist core with the TC production option bundle (diagnostic
    condensation + rate cap, active sedimentation, Smagorinsky + implicit
    vertical diffusion, bulk air-sea fluxes, the outer sponge), 12 levels,
    its sounding written under ``tdir``."""
    mvars = {"s": 1, "xi": 2, "mu": 3, "u": 4, "v": 5, "w": 6,
             "mu_c": 7, "mu_r": 8, "qss": 9}
    zs = np.linspace(0.0, 12000.0, 25)
    snd = os.path.join(tdir, "snd.txt")
    with open(snd, "w") as f:
        f.write("1015.0 300.0 12.0\n")
        for z in zs[1:]:
            f.write(f"{z} {300.0 + 0.004 * z} {12.0 * np.exp(-z / 2500.0)}\n")
    gp = GridParameters(
        geometry="RLZ", xmin=0.0, xmax=100.0e3, num_cells=cells, lDim=4,
        zmin=0.0, zmax=10000.0, zDim=12,
        BCL={"u": BC.R1T0, "v": BC.R1T0, "w": BC.R1T1},
        BCR={"u": BC.R1T0},
        BCB={"s": ZBC.R1T1, "u": ZBC.R1T1, "v": ZBC.R1T1, "mu": ZBC.R1T1,
             "mu_c": ZBC.R1T1, "w": ZBC.R1T0},
        BCT={"s": ZBC.R1T1, "u": ZBC.R1T1, "v": ZBC.R1T1, "mu": ZBC.R1T1,
             "mu_c": ZBC.R1T1, "mu_r": ZBC.R1T1, "w": ZBC.R1T0},
        vars=mvars,
    )
    return ModelParameters(
        ts=0.5, integration_time=1.0, output_interval=1.0,
        equation_set="MoistEulerRLZ",
        initial_conditions=os.path.join(tdir, "unused.csv"),
        output_dir=tdir, ref_state_file=snd, grid_params=gp,
        physical_params={"K": 5.0, "f": 5.0e-5},
        options={"semiimplicit": True, "stiff_relaxation": "exp",
                 "implicit_vdiff": True, "smagorinsky": 0.2,
                 "condensation": "diagnostic",
                 "condensation_rate_cap": 5.0e-5,
                 "sedimentation": "active",
                 "sponge_width": 20.0e3, "sponge_tau": 1800.0,
                 "surface_fluxes": {"sst": 301.15, "Ck": 1.2e-3,
                                    "Cd": 1.5e-3, "depth": 600.0,
                                    "wind_floor": 2.0}},
    )


def _one_sharded_step(model, grid, ctx, dtype, mesh, method, interface, state):
    """One sharded step from a whole ``state`` (canonical layout); returns
    the whole spectral state after it, checked finite."""
    n = mesh.size
    if method == "halo":
        state = state._replace(
            spec=sh.spec_to_blocks(state.spec, n, grid.params.num_cells // n))
    step = sh.build_sharded_step(model, grid, ctx, dtype, mesh, method, interface)
    spec = sh.gather_global(step(sh.shard_state(state, mesh, method)).spec)
    if not torch.isfinite(spec).all():
        raise FloatingPointError(f"{model.equation_set} by {method}: a non-finite step")
    return spec


def _zero_state(model, grid, dtype, boundary_ctx=None):
    """The initial state of zero perturbation fields (the boundary
    references of ``boundary_ctx`` set from it where given)."""
    spec0 = grid.analysis(torch.zeros((grid.nvars,) + grid.spatial_shape, dtype=dtype,
                                      device=grid.device))
    if boundary_ctx is not None:
        _set_boundary_refs(boundary_ctx, grid, spec0)
    return ti.initial_state(spec0, (grid.nvars,) + grid.spatial_shape, dtype,
                            imp_rows=imp_history_rows(model))


def dryrun_models(tdir, n_devices: int):
    """The moist models of ``dryrun_multichip(n_devices)``, their files
    written under ``tdir``, at >= 4 cells a shard: the RLZ moist core with
    the TC production bundle, the SLZ shell with the JW06 options, and the
    XYZ shower's production bundle (diagnostic condensation, rate cap, modal
    filter)."""
    from .examples import convective_shower_xyz as xw
    from .examples import jw06_baroclinic_slz as jw

    cells = max(4 * n_devices, 8)
    xmodel = xw.build_model(os.path.join(tdir, "xyz"), num_cells=cells, ny=4, nz=10,
                            ts=0.25, t_end=0.5)
    xmodel = xmodel.with_(options={**xmodel.opts(), "condensation": "diagnostic",
                                   "condensation_rate_cap": 2.0e-4,
                                   "modal_filter_tau": 30.0})
    return (_rlz_tc_model(tdir, cells),
            jw.build_model(os.path.join(tdir, "slz"), num_cells=cells, nl=8, zdim=8,
                           ts=0.5, t_end=1.0, filter_tau=30.0),
            xmodel)


def dryrun_multichip(n_devices: int, dtype=None, device=DEFAULT) -> list[str]:
    """One sharded step of every group on a mesh of ``n_devices`` shards
    (``sh.make_mesh``: a ThreadMesh, or the DistMesh of an initialised
    torch.distributed group) on ``device`` (the card unless the caller asks
    for the CPU); prints a line a step and returns their labels."""
    from .model import integrate_ensemble

    dtype = dtype or torch.get_default_dtype()
    n = n_devices
    mesh = sh.make_mesh(n, device=device)
    done = []

    def report(label):
        print(f"dryrun_multichip({n}, {label}): one sharded step OK", flush=True)
        done.append(label)

    configs = [("psum", "gather")]
    if n >= 2:
        configs += [("halo", "gather"), ("halo", "pcr")]

    def name(method, interface):
        return method + (f"/{interface}" if method == "halo" else "")

    # the flagship at >= 4 cells a shard (the halo/Schur minimum) x 16,
    # without and with the modal filter on both spectral layouts
    model = cb.flagship_model(num_cells=4 * n, nl=16)
    grid = create_grid(model.grid_params, dtype, device=device)
    ctx = build_context(model, grid, dtype)
    fmodel = model.with_(options={"modal_filter_tau": 30.0})
    for m, label in ((model, ""), (fmodel, "+filter")):
        c = ctx if m is model else build_context(m, grid, dtype)
        for method, interface in configs:
            _one_sharded_step(m, grid, c, dtype, mesh, method, interface,
                              cb.vortex_state(grid, dtype))
            report(name(method, interface) + label)

    with tempfile.TemporaryDirectory(prefix="graft_") as tdir:
        mmodel, smodel, xmodel = dryrun_models(tdir, n)
        # the RLZ moist core with the TC production bundle
        mgrid = create_grid(mmodel.grid_params, dtype, device=device)
        for method, interface in configs:
            mctx = build_context(mmodel, mgrid, dtype)
            _one_sharded_step(mmodel, mgrid, mctx, dtype, mesh, method, interface,
                              _zero_state(mmodel, mgrid, dtype, mctx))
            report(name(method, interface) + "+tc-production/wishe+ivd+smag+sponge")

        # the SLZ shell (latitude sharded) with the JW06 options
        sgrid = create_grid(smodel.grid_params, dtype, device=device)
        sctx = build_context(smodel, sgrid, dtype)
        for method, interface in configs:
            _one_sharded_step(smodel, sgrid, sctx, dtype, mesh, method, interface,
                              _zero_state(smodel, sgrid, dtype))
            report(name(method, interface) + "+slz-jw06/si+filter")

        # the XYZ shower's production bundle
        xgrid = create_grid(xmodel.grid_params, dtype, device=device)
        xctx = build_context(xmodel, xgrid, dtype)
        for method, interface in configs:
            _one_sharded_step(xmodel, xgrid, xctx, dtype, mesh, method, interface,
                              _zero_state(xmodel, xgrid, dtype))
            report(name(method, interface) + "+xyz-shower/diagnostic+filter")

    # the gradient of a 4D-Var cost through two sharded flagship steps
    for method, interface in configs:
        spec0 = cb.vortex_state(grid, dtype).spec
        if method == "halo":
            spec0 = sh.spec_to_blocks(spec0, n, grid.params.num_cells // n)
        spec0 = spec0.detach().requires_grad_(True)
        cost = fourdvar_cost(model, grid, ctx, dtype, mesh, method, interface)(spec0)
        (grad,) = sh.replicated_grad(cost, spec0, mesh)
        if not (torch.isfinite(cost) and torch.isfinite(grad).all()
                and float(grad.abs().max()) > 0.0):
            raise FloatingPointError(f"4D-Var gradient by {method}: {float(cost)}")
        print(f"dryrun_multichip({n}, {name(method, interface)}+4dvar-grad): sharded "
              "value and gradient OK", flush=True)
        done.append(name(method, interface) + "+4dvar-grad")

    # members as the mesh axis, no communication
    emodel = cb.flagship_model(num_cells=8, nl=16).with_(integration_time=6.0,
                                                         output_interval=6.0)
    egrid = create_grid(emodel.grid_params, torch.float64, device="cpu")  # the ICs
    base = cb.vortex_phys(egrid)
    ics = np.stack([base * (1.0 + 0.01 * k) for k in range(n)])
    _, out = integrate_ensemble(emodel, ics, dtype=dtype,
                                mesh=sh.make_ensemble_mesh(n, device=device))
    if not np.isfinite(out).all():
        raise FloatingPointError("a non-finite ensemble member")
    print(f"dryrun_multichip({n}, ensemble): {n} sharded members OK, out shape {out.shape}",
          flush=True)
    done.append("ensemble")
    return done


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else DEFAULT
    fn, fargs = entry(device=device)
    out = fn(*fargs)
    if not torch.isfinite(out.spec).all():
        raise FloatingPointError("entry(): a non-finite step")
    print("entry(): one step OK", flush=True)
    # as the JAX file's one shard a device: the cards, or the one CPU
    dryrun_multichip(1 if args.cpu else torch.cuda.device_count(), device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
