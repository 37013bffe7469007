"""Radial domain decomposition over shards, in PyTorch.

The counterpart of ``scythe_tpu.parallel.sharding``.  Physical arrays are
split along the radial mish axis, cut on cell boundaries so each shard owns
whole spline cells; azimuth and the vertical columns stay whole on every
shard.  The step is written once, as the body one shard runs, and a
``parallel.mesh`` mesh runs it: a ``ThreadMesh`` (shards as threads of this
process, on one card or several) or a ``DistMesh`` (one shard a process of
a torch.distributed group, NCCL or gloo).

Two analyses, as in the JAX package:

* "psum": every shard projects its rows (``Grid.project``, an exact sum of
  per-cell contributions), one ``psum`` adds the projections, and every
  shard solves the small replicated system (``Grid.solve_spectral``); the
  spectral state is replicated.  Equal to the one-device analysis up to the
  order of the sum.
* "halo": every shard holds its coefficient window (its cells and 3 halo
  rows, ``spec_to_blocks``) and the analysis is the distributed Schur
  solve of ``parallel/schur.py``: two 3-row ppermutes, the interface solve
  (a 3-row-a-shard all_gather and a dense inverse row, "gather"; or
  parallel cyclic reduction by O(log n) 3-row ppermutes, "pcr"), and
  one more 3-row ppermute.  Synthesis needs no communication.

A sharded tensor is a ``Sharded``: this process's shards, cut along one
axis or replicated, the counterpart of a jax.Array under a NamedSharding.

Gradients: torch.autograd differentiates the sharded step on either mesh
(``parallel/mesh.py`` gives every collective its adjoint), with or without
``torch.utils.checkpoint`` around each step.  The cotangent a shard holds
of a replicated value (the psum path's spectral state, a cost every rank
computes from ``gather_global``) is its share, as in JAX's shard_map.
``replicated_grad`` is the one way to get a replicated cost's gradient
whole on every rank, on both meshes and on one device.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import numpy as np
import torch

from .. import timeintegration as ti
from ..device import DEFAULT
from ..graphs import not_capturable
from ..grids.base import Grid, _split3
from ..model import build_context, build_step
from . import schur as schur_mod
from .mesh import DistMesh, Mesh, make_ensemble_mesh, make_mesh  # noqa: F401

METHODS = ("psum", "halo")


class Sharded:
    """A tensor over a mesh's shards: ``parts`` are this process's shards in
    the order of ``mesh.local_ranks``, cut along ``axis`` into equal pieces
    in rank order, or each a copy of one value when ``axis`` is None."""

    __slots__ = ("parts", "axis", "mesh")

    def __init__(self, parts, axis: int | None, mesh: Mesh):
        self.parts = list(parts)
        self.axis = axis
        self.mesh = mesh

    def __repr__(self):
        shapes = [tuple(p.shape) for p in self.parts]
        return f"Sharded(axis={self.axis}, parts={shapes}, mesh={self.mesh!r})"


def gather_global(x) -> torch.Tensor:
    """A sharded tensor -> the whole tensor, on the device of this process's
    first shard; a tensor is returned as it is.  On a DistMesh every rank
    gathers (an all_gather: the ``--multihost`` path of the JAX package's
    CLI), so every rank calls it, at output boundaries and for a cost.
    Differentiable; a cost of its result is replicated, so take its
    gradient by ``replicated_grad``."""
    if not isinstance(x, Sharded):
        return x
    if x.axis is None:
        return x.parts[0]
    return x.mesh.gather(x.parts, x.axis)


def replicated_grad(output: torch.Tensor, inputs, mesh: Mesh | None = None) -> tuple:
    """The gradient of ``output``, a scalar every rank holds whole (a cost
    of ``gather_global``'s tensors), with respect to ``inputs`` (a tensor or
    a sequence of them, each whole on every rank: a control that
    ``shard_state`` cuts, a physical parameter every shard's step reads),
    whole on every rank, as the tuple ``torch.autograd.grad`` returns.

    The convention is JAX's: the cotangent a rank holds of a replicated
    value is its share, and the whole cotangent is the sum of the shares.
    On a ``DistMesh`` every rank computes ``output``, so each seeds 1/size
    of its cotangent, and an input's gradient on a rank, its share, is
    summed over the ranks (an all_reduce): every rank calls this, as a
    collective.  A ``ThreadMesh`` is one graph in this process, whose
    shards' cotangents meet in the tensors they share, and ``mesh`` None is
    one device: for both this is ``torch.autograd.grad(output, inputs)``."""
    inputs = (inputs,) if torch.is_tensor(inputs) else tuple(inputs)
    if not isinstance(mesh, DistMesh):
        return torch.autograd.grad(output, inputs)
    seed = torch.full_like(output, 1.0 / mesh.size)
    grads = torch.autograd.grad(output, inputs, seed, allow_unused=True)
    # a rank none of whose share reached an input still joins the sum
    return tuple(mesh.psum(torch.zeros_like(x) if g is None else g)
                 for x, g in zip(inputs, grads))


def _check_divisible(grid: Grid, n: int):
    if grid.params.num_cells % n != 0:
        raise ValueError(
            f"num_cells={grid.params.num_cells} must be divisible by the "
            f"mesh size {n} (shards own whole spline cells)"
        )


def _check_method(method: str):
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")


def _to(x, device):
    """Tensors (in dicts, tuples and named tuples too) onto ``device``."""
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, device) for v in x))
    return x


def _same_device(a, b) -> bool:
    """Whether two devices are one: a bare "cuda" is the current card."""
    def canon(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d

    return canon(a) == canon(b)


def _grid_on(grid: Grid, device: torch.device) -> Grid:
    """The grid itself on its own device, else a shallow copy with every
    operator on ``device`` (a ThreadMesh shard on another card)."""
    if _same_device(grid.device, device):
        return grid
    g = copy.copy(grid)
    for f in dataclasses.fields(grid):
        val = getattr(grid, f.name)
        if torch.is_tensor(val):
            setattr(g, f.name, val.to(device))
    if grid.l_fact is not None:
        g.l_fact = copy.copy(grid.l_fact)
        for k, v in vars(grid.l_fact).items():
            if torch.is_tensor(v):
                setattr(g.l_fact, k, v.to(device))
    g.device = device
    return g


def _ctx_on(ctx, device: torch.device):
    if _same_device(ctx.grid.device, device):
        return ctx
    return dataclasses.replace(ctx, coords=_to(ctx.coords, device),
                               ref_state=_to(ctx.ref_state, device),
                               extras=_to(ctx.extras, device))


def _rows(t: torch.Tensor, axis: int, start: int, rows: int) -> torch.Tensor:
    return t.narrow(axis, start, rows).contiguous()


def _refuse_analysis(phys):
    raise RuntimeError(
        "a shard's grid holds only its own rows and cannot analyse: the "
        "sharded analysis is the step's analysis_fn (EqContext.analysis)"
    )


def _shard_rows(grid: Grid, lg: Grid, start: int, rows: int):
    """The radial rows every shard grid slices alike: the fast derivative
    operators' rows are done by the caller; here the ring mask and the
    Smagorinsky ring spacing, and ``analysis``, which a shard cannot do."""
    from ..physics.turbulence import ring_arc_spacing

    if grid.ring_mask is not None:
        lg.ring_mask = _rows(grid.ring_mask, 0, start, rows)
    # Smagorinsky per-ring arc spacing [rDim] -> this shard's rows (the
    # closure's only radially shaped static input, cached on the grid)
    dy = ring_arc_spacing(grid)
    lg.smag_dy = dy[start:start + rows] if getattr(dy, "ndim", 0) >= 1 else dy
    lg.analysis = _refuse_analysis


def _local_grid(grid: Grid, idx: int, rows: int) -> Grid:
    """A shallow grid copy whose radial-row operators are this shard's
    slice (synthesis rows, projection columns, ring mask, Smagorinsky
    spacing).  Compensated operator stacks carry a leading length-3 axis."""
    start = idx * rows
    off = 1 if grid.comp else 0
    lg = copy.copy(grid)
    lg.synth_r = _rows(grid.synth_r, 1 + off, start, rows)
    lg.synth_r_val = _rows(grid.synth_r_val, 0 + off, start, rows)
    lg.project_r = _rows(grid.project_r, 1 + off, start, rows)
    if grid.fast:  # single-pass bf16 derivative operators (no comp axis)
        lg.synth_r_deriv_f = _rows(grid.synth_r_deriv_f, 1, start, rows)
        lg.synth_r_val_f = _rows(grid.synth_r_val_f, 0, start, rows)
    _shard_rows(grid, lg, start, rows)
    return lg


def _local_coords(coords: dict, idx: int, rows: int) -> dict:
    """Every radially shaped coordinate sliced to this shard's rows.  Keyed
    by shape, not name: "r" and its aliases ("lat", "x") span the mish axis
    on axis 0; the others carry a leading broadcast axis of length 1."""
    full = coords["r"].shape[0]
    return {k: (_rows(v, 0, idx * rows, rows)
                if torch.is_tensor(v) and v.ndim >= 1 and v.shape[0] == full else v)
            for k, v in coords.items()}


# Radial axis of every known ctx.extras entry (None = not radially shaped,
# never sliced).  Keyed by NAME: a shape rule would mis-slice an entry
# whose leading size happens to equal rDim.  Register new extras here.
_EXTRAS_RADIAL_AXIS = {
    "hs_grad": 1,  # topography gradient [2, rDim, nl] (model._set_topography)
    "hs_filtered": 0,  # filtered topography [rDim, nl]
    "sponge_ref": 1,  # sponge reference state [nvars, rDim, ...]
    "radiation_ref_dr": 1,  # radiation d/dr reference [nvars, rDim, ...]
}


def _local_extras(extras: dict, idx: int, rows: int, rDim: int) -> dict:
    """Radially shaped auxiliary fields sliced to this shard's rows:
    registered entries on their declared axis; an unregistered (user's)
    entry by the JAX package's shape rule, axis 1 == rDim before axis 0."""
    out = {}
    for key, val in extras.items():
        if key in _EXTRAS_RADIAL_AXIS:
            ax = _EXTRAS_RADIAL_AXIS[key]
            if ax is not None:
                val = _rows(val, ax, idx * rows, rows)
        elif torch.is_tensor(val) and val.ndim >= 2 and val.shape[1] == rDim:
            val = _rows(val, 1, idx * rows, rows)
        elif torch.is_tensor(val) and val.ndim >= 1 and val.shape[0] == rDim:
            val = _rows(val, 0, idx * rows, rows)
        out[key] = val
    return out


def state_specs(method: str = "psum") -> ti.ModelState:
    """The radial axis of each ModelState field (None: replicated): the
    spectral state replicated on the psum path and split into its windows
    on the halo path; the physical histories split either way."""
    _check_method(method)
    return ti.ModelState(
        spec=None if method == "psum" else 1,
        expdot_nm1=1, expdot_nm2=1, impdot_nm1=1, impdot_nm2=1, t=None,
    )


def shard_state(state: ti.ModelState, mesh: Mesh, method: str = "psum") -> ti.ModelState:
    """A whole ModelState (on the halo path its spectral state already in
    windowed blocks, ``spec_to_blocks``) onto the mesh: each field a
    ``Sharded`` of this process's shards on their devices; ``t`` stays."""
    specs = state_specs(method)
    out = {}
    for name, axis in zip(ti.ModelState._fields, specs):
        x = getattr(state, name)
        if name == "t":
            out[name] = x
            continue
        pieces = x.chunk(mesh.size, dim=axis) if axis is not None else None
        out[name] = Sharded(
            [(x if axis is None else pieces[r]).to(mesh.device_of(r)).contiguous()
             for r in mesh.local_ranks], axis, mesh)
    return ti.ModelState(**out)


# ---------------------------------------------------------------------------
# Halo (Schur) path: windowed spectral state, O(halo) per-step communication.
# See parallel/schur.py for the factorization; ref semiimplicit.jl:84-86.


def spec_to_blocks(spec: torch.Tensor, n: int, cl: int) -> torch.Tensor:
    """Canonical spectral [v, nb, ...] -> windowed blocks [v, n*W, ...]
    (window i = raw coefficient rows [i*cl, i*cl+cl+3); halo rows are
    duplicated across neighbours by construction)."""
    W = cl + schur_mod.HALO
    return torch.cat([spec[:, i * cl:i * cl + W] for i in range(n)], dim=1)


def blocks_to_spec(blocks: torch.Tensor, n: int, cl: int) -> torch.Tensor:
    """Windowed blocks [v, n*W, ...] -> canonical spectral [v, nb, ...]
    (halo duplicates dropped; the last shard's window is all its own)."""
    W = cl + schur_mod.HALO
    parts = [blocks[:, i * W:i * W + cl] for i in range(n - 1)]
    parts.append(blocks[:, (n - 1) * W:n * W])
    return torch.cat(parts, dim=1)


def _take_shard(arr: torch.Tensor, idx: int, comp: bool) -> torch.Tensor:
    """Shard ``idx`` of a stacked [n, ...] (compensated: [3, n, ...])
    operator array."""
    return arr.select(1 if comp else 0, idx).contiguous()


# shard counts at/above which the halo path defaults to the PCR interface
# solve (O(log n) 3-row ppermutes; measured <= 3 levels for any n) instead
# of the 3-rows-per-shard all_gather + dense [6, 3n] matvec (O(n)).
PCR_AUTO_MIN = 16


class HaloOps:
    """The Schur matrices stacked over shards, through the grid's matmul
    mode (its dtype, or the compensated bf16 stack), on the grid's device,
    and the partition's static facts.

    ``interface``: how the eliminated block-tridiagonal interface system is
    solved at run time: "gather" (all_gather + precomputed dense inverse
    rows; O(n) a shard) or "pcr" (parallel cyclic reduction,
    ``schur.build_pcr_ops``; O(log n), in practice <= 3 levels of 3-row
    ppermute pairs).  "auto" takes pcr for n >= PCR_AUTO_MIN."""

    def __init__(self, grid: Grid, n: int, interface: str = "auto"):
        if interface == "auto":
            interface = "pcr" if n >= PCR_AUTO_MIN else "gather"
        if interface not in ("gather", "pcr"):
            raise ValueError(f"unknown interface {interface!r}")
        # the per-variable interior eliminations are the expensive set-up
        # step: made once and shared; no O(n^2) CS inverse when PCR solves
        # the interface at run time
        ifaces = schur_mod.var_interfaces(grid.params, n)
        sops = schur_mod.build_schur_ops(
            grid.params, n, ifaces=ifaces, include_cs=(interface == "gather"))

        def prep(a):
            if grid.comp:
                return _split3(a).to(dtype=grid.dtype, device=grid.device)
            return torch.as_tensor(np.asarray(a), dtype=grid.dtype, device=grid.device)

        self.comp = grid.comp
        self.interface = interface
        self.n, self.cl, self.W = sops.n, sops.cl, sops.W
        self.GL = prep(sops.GL)
        self.GRr = prep(sops.GRr)
        self.AP = prep(sops.AP)
        self.AC = prep(sops.AC)
        if interface == "pcr":
            pops = schur_mod.build_pcr_ops(grid.params, n, ifaces=ifaces)
            self.levels = pops.levels
            self.dists = pops.dists
            self.A = [prep(pops.A[k]) for k in range(pops.levels)]
            self.B = [prep(pops.B[k]) for k in range(pops.levels)]
            self.Dinv = prep(pops.Dinv)
        else:
            self.CS = prep(sops.CS)

    def shard(self, idx: int, device: torch.device) -> dict:
        """Shard ``idx``'s operators on ``device``."""
        def take(a):
            return _take_shard(a, idx, self.comp).to(device)

        ops = {k: take(getattr(self, k)) for k in ("GL", "GRr", "AP", "AC")}
        if self.interface == "pcr":
            ops["A"] = [take(a) for a in self.A]
            ops["B"] = [take(b) for b in self.B]
            ops["Dinv"] = take(self.Dinv)
        else:
            ops["CS"] = take(self.CS)
        return ops


def _window_grid(grid: Grid, idx: int, n: int) -> Grid:
    """A shallow grid copy whose radial operators are this shard's WINDOW
    slices: synthesis maps the coefficient window [W] to the shard's
    physical rows and projection the rows to the window, so synthesis on
    the windowed layout needs no communication."""
    cl = grid.params.num_cells // n
    W = cl + schur_mod.HALO
    rows = grid.params.rDim // n
    r0, b0 = idx * rows, idx * cl
    off = 1 if grid.comp else 0
    lg = copy.copy(grid)
    lg.synth_r = _rows(_rows(grid.synth_r, 1 + off, r0, rows), 2 + off, b0, W)
    lg.synth_r_val = _rows(_rows(grid.synth_r_val, 0 + off, r0, rows), 1 + off, b0, W)
    lg.project_r = _rows(_rows(grid.project_r, 0 + off, b0, W), 1 + off, r0, rows)
    if grid.fast:  # single-pass bf16 derivative operators (no comp axis)
        lg.synth_r_deriv_f = _rows(_rows(grid.synth_r_deriv_f, 1, r0, rows), 2, b0, W)
        lg.synth_r_val_f = _rows(_rows(grid.synth_r_val_f, 0, r0, rows), 1, b0, W)
    _shard_rows(grid, lg, r0, rows)
    return lg


def _halo_analysis(wg: Grid, ops: dict, hops: HaloOps, mesh: Mesh, phys):
    """The distributed exact analysis on the windowed layout: the shard's
    projection, one 3-row overflow ppermute, the shard's Schur elimination,
    the interface solve (``hops.interface``: a 3-row-a-shard all_gather and
    a dense inverse-row product, or parallel cyclic reduction by O(log n)
    3-row ppermute pairs), the shard's back-substitution, and one 3-row
    halo ppermute.  Returns the shard's spectral window [v, W, ...]."""
    n, cl = hops.n, hops.cl
    idx = mesh.index
    right = [(i, (i + 1) % n) for i in range(n)]
    left = [(i, (i - 1) % n) for i in range(n)]
    is_last = float(idx == n - 1)
    mm = wg._mm

    p_loc = wg.project(phys)  # [v, W, ...]
    tail = p_loc[:, cl:] * (1.0 - is_last)  # the last shard owns its tail
    recv = mesh.ppermute(tail, right)
    p_own = p_loc.clone()
    p_own[:, cl:] *= is_last
    p_own[:, :3] += recv

    g = mm("vsw,vw...->vs...", ops["GL"], p_own)
    gr = mm("vsw,vw...->vs...", ops["GRr"], p_own)
    g = g + mesh.ppermute(gr, right)

    if hops.interface == "pcr":
        y = g
        for k in range(hops.levels):
            dk = hops.dists[k]
            y_prev = mesh.ppermute(y, [(i, (i + dk) % n) for i in range(n)])  # y_{i-d}
            y_next = mesh.ppermute(y, [(i, (i - dk) % n) for i in range(n)])  # y_{i+d}
            y = (y + mm("vab,vb...->va...", ops["A"][k], y_prev)
                 + mm("vab,vb...->va...", ops["B"][k], y_next))
        c = mm("vab,vb...->va...", ops["Dinv"], y)
        c_next = mesh.ppermute(c, left)  # c_{i+1}
        c6 = torch.cat([c, c_next], dim=1)
    else:
        g_all = mesh.all_gather(g)  # [n, v, 3, ...]
        g_flat = g_all.movedim(0, 1).reshape((g.shape[0], 3 * n) + tuple(g.shape[2:]))
        c6 = mm("vsg,vg...->vs...", ops["CS"], g_flat)

    a_own = (mm("vuw,vw...->vu...", ops["AP"], p_own)
             + mm("vus,vs...->vu...", ops["AC"], c6))
    head = mesh.ppermute(a_own[:, :3].contiguous(), left)
    out = a_own.clone()
    out[:, cl:] += head * (1.0 - is_last)
    return out


def _modal_filter(grid: Grid, model, dtype):
    """The per-step modal filter of the options on ``grid`` (acting on the
    canonical layout), or None when the options have none."""
    opts = model.opts()
    mf_tau = float(opts.get("modal_filter_tau", 0.0) or 0.0)
    if mf_tau <= 0.0:
        return None
    from ..model import build_modal_filter

    return build_modal_filter(grid, mf_tau, int(opts.get("modal_filter_order", 4)),
                              model.ts, dtype,
                              axes=str(opts.get("modal_filter_axes", "rlz")))


def _under_callers_hooks(fn):
    """``fn`` under the caller's saved-tensor hooks.  They are thread-local,
    and a ThreadMesh runs each shard in a thread of its own: without them,
    ``torch.utils.checkpoint`` around a sharded step would neither drop the
    step's activations nor recompute them in the backward.  (The early stop
    of a recompute, raised in a shard, is re-raised by ``run``.)"""
    hooks = torch._C._autograd._top_saved_tensors_default_hooks(False)
    if hooks is None:
        return fn

    def run(*args):
        with torch.autograd.graph.saved_tensors_hooks(*hooks):
            return fn(*args)

    return run


def build_sharded_step(model, grid: Grid, ctx, dtype, mesh: Mesh, method="psum",
                       interface="auto"):
    """The step over the mesh's shards: step(state) -> state on ``Sharded``
    states (``shard_state``); compose with ``model.make_scan``.  Each
    shard's step (its grid rows, coordinates, extras, and the semi-implicit
    and filter operators on its device) is built once, here.

    ``method``:

    * "psum" (the default, best for few shards): spectral state replicated;
      analysis = the shard's projection, a psum of the whole projection
      array, the replicated solve.
    * "halo" (scalable): spectral state as each shard's coefficient
      window; analysis = the Schur-complement distributed solve with
      O(halo) communication (``parallel/schur.py``); equal to "psum" to
      round-off.  ``interface``: "gather" / "pcr" / "auto" (HaloOps).

    The per-step modal filter acts on the canonical layout: on psum
    directly (the replicated state is canonical); on halo each shard
    gathers the small windowed state once at filter time, filters it
    canonically and keeps its own window again."""
    _check_method(method)
    n = mesh.size
    _check_divisible(grid, n)
    rows = grid.params.rDim // n
    cl = grid.params.num_cells // n
    W = cl + schur_mod.HALO
    hops = HaloOps(grid, n, interface) if method == "halo" else None
    filters: dict = {}  # the base filter a device

    def shard_step(r):
        dev = mesh.device_of(r)
        g = _grid_on(grid, dev)
        c = _ctx_on(ctx, dev)
        if dev not in filters:
            filters[dev] = _modal_filter(g, model, dtype)
        base_filter = filters[dev]
        modal_filter_fn = base_filter
        if method == "halo":
            lg = _window_grid(g, r, n)
            ops = hops.shard(r, dev)

            def analysis_fn(phys):
                return _halo_analysis(lg, ops, hops, mesh, phys)

            if base_filter is not None:
                def modal_filter_fn(win):
                    g_all = mesh.all_gather(win)
                    blocks = g_all.movedim(0, 1).reshape(
                        (win.shape[0], n * W) + tuple(win.shape[2:]))
                    out = spec_to_blocks(base_filter(blocks_to_spec(blocks, n, cl)), n, cl)
                    return out.narrow(1, mesh.index * W, W)
        else:
            lg = _local_grid(g, r, rows)

            def analysis_fn(phys):
                return g.solve_spectral(mesh.psum(lg.project(phys)))

        lctx = dataclasses.replace(
            c, grid=lg, coords=_local_coords(c.coords, r, rows),
            extras=_local_extras(c.extras, r, rows, grid.params.rDim))
        return build_step(model, lg, lctx, dtype, analysis_fn=analysis_fn,
                          synthesis_fn=lg.synthesis, modal_filter_fn=modal_filter_fn)

    steps = [shard_step(r) for r in mesh.local_ranks]
    specs = state_specs(method)

    def step(state: ti.ModelState) -> ti.ModelState:
        per = [ti.ModelState(*(f.parts[i] for f in state[:5]), state.t)
               for i in range(len(steps))]
        out = mesh.run(_under_callers_hooks(lambda st, shard: shard(st)), per, steps)
        return ti.ModelState(
            *(Sharded([o[k] for o in out], specs[k], mesh) for k in range(5)),
            out[0].t)

    # its shards run as threads taking turns or as ranks between collectives:
    # make_scan runs it eagerly, never as a captured graph
    return not_capturable(step)


def integrate_sharded(model, n_devices: int | None = None, dtype=None, method="psum",
                      interface="auto", write_outputs=True, resume_from: str | None = None,
                      profile_dir: str | None = None, device: Any = DEFAULT):
    """The sharded counterpart of ``model.integrate_model``, with its
    output cadence, NaN watchdog, ``scythe_out.log``, checkpoints, bitwise
    resume and profiler trace: the radial axis split over ``n_devices``
    shards (``make_mesh``: threads of this process on ``device``, the card
    unless the caller asks for the CPU; or the ranks of an initialised
    torch.distributed group) by the analysis ``method`` and, on "halo", the
    ``interface`` solve.  Checkpoints are canonical, so a sharded run
    resumes from a one-device checkpoint and the other way round.  Returns
    (grid, final physical values [nvars, *spatial] as a numpy array)."""
    from ..model import logged_run, run_loop

    dtype = dtype or torch.get_default_dtype()
    mesh = make_mesh(n_devices, device=device)
    n = mesh.size
    with logged_run(model, profile_dir):
        grid, ctx, state = initialize_sharded(model, mesh, dtype, method,
                                              device=mesh.device_of(mesh.local_ranks[0]))
        step = build_sharded_step(model, grid, ctx, dtype, mesh, method, interface)
        cl = grid.params.num_cells // n
        to_canonical = None
        if method == "halo":
            def to_canonical(spec):
                return blocks_to_spec(spec, n, cl)

            def from_canonical(st):
                return shard_state(st._replace(spec=spec_to_blocks(st.spec, n, cl)),
                                   mesh, method)
        else:
            def from_canonical(st):
                return shard_state(st, mesh, method)
        return run_loop(model, grid, ctx, state, step, dtype,
                        write_outputs=write_outputs, resume_from=resume_from,
                        to_canonical=to_canonical, from_canonical=from_canonical,
                        gather=gather_global)


def initialize_sharded(model, mesh: Mesh, dtype=None, method="psum", matmul="auto",
                       device: Any = DEFAULT):
    """The sharded counterpart of ``model.initialize``: the grid, context
    and (on every shard's device) the initial state.  The grid and context
    are whole, on ``device`` (the card unless the caller asks for the CPU);
    the initial analysis is the grid's own, on the whole field.
    ``matmul`` goes to create_grid."""
    from .. import io as sio
    from ..grids.base import create_grid
    from ..model import _set_boundary_refs, _set_topography, imp_history_rows

    _check_method(method)
    dtype = dtype or torch.get_default_dtype()
    grid = create_grid(model.grid_params, dtype, matmul=matmul, device=device)
    n = mesh.size
    _check_divisible(grid, n)
    ctx = build_context(model, grid, dtype)
    phys0 = sio.read_physical_grid(model.initial_conditions, grid)
    spec0 = grid.analysis(torch.as_tensor(phys0, dtype=dtype, device=grid.device))
    _set_boundary_refs(ctx, grid, spec0)
    _set_topography(ctx, grid)
    if method == "halo":
        spec0 = spec_to_blocks(spec0, n, grid.params.num_cells // n)
    state = ti.initial_state(spec0, (grid.nvars,) + grid.spatial_shape, dtype,
                             imp_rows=imp_history_rows(model))
    return grid, ctx, shard_state(state, mesh, method)
