"""Differentiable integration: reverse-mode AD through the full core, in
PyTorch.

The counterpart of ``scythe_tpu.adjoint``.  The step is a function of the
state built from torch operations and the two hand-written kernels, each a
``torch.autograd.Function`` (``ops.column_solve.ColumnSolveFn``,
``ops.rlz_analysis.RLZAnalysisFn``), so ``torch.autograd`` differentiates the
whole integration: exact discrete adjoints of the production step, on the
card through the kernels' backward rules.

``make_simulator`` returns ``sim(params, phys0) -> final fields``; with
``remat`` each step runs under ``torch.utils.checkpoint`` (non-reentrant), so
reverse-mode memory is one state a step, not every step's intermediates.
The steps are a plain Python loop (the JAX package scans bounded chunks to
cap its compile time; eager PyTorch compiles nothing).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import timeintegration as ti
from .config import ModelParameters
from .device import DEFAULT
from .grids.base import create_grid
from .model import _set_boundary_refs, build_context, build_step, infer_radiation_speed


def make_simulator(
    model: ModelParameters,
    dtype=None,
    n_steps: int | None = None,
    remat: bool = True,
    device: Any = DEFAULT,
):
    """Build a differentiable end-to-end simulator for ``model`` on
    ``device`` (the card unless the caller asks for the CPU).

    Returns ``(sim, grid, ctx)``; ``sim(params, phys0)`` integrates
    ``n_steps`` (default: ``integration_time / ts``) from the physical
    initial fields ``phys0`` ([nvars, *spatial], a numpy array or a tensor,
    which may need a gradient) and returns the final physical fields;
    ``sim.fields_at(params, phys0, steps)`` returns the fields after each
    of several step counts from one integration (a 4D-Var window's
    observation times).

    ``params`` overrides physical parameters (a subset of
    ``model.physical_params``, e.g. ``{"Cd": cd}``); a tensor that needs a
    gradient stays one through every equation set, so
    ``torch.autograd.grad`` differentiates the nonlinear integration with
    respect to it.

    As in the JAX package, parameters that feed set-up scalars are baked in
    at their static values: the semi-implicit Helmholtz operator (from the
    reference state) and an inferred ``radiation_speed`` (resolved here
    from the static parameters; set ``options['radiation_speed']`` to
    calibrate ``g`` / ``H``).  Equation sets that branch in Python on a
    parameter (LinearAdvectionRL's ``if K > 0``) need it left static.

    ``remat=True`` runs each step under ``torch.utils.checkpoint``
    (``use_reentrant=False``) while autograd records: the backward recomputes
    a step's intermediates, so each kernel launches once more a step in a
    backward pass.  Under ``torch.no_grad()`` steps run plain."""
    dtype = dtype or torch.get_default_dtype()
    opts = model.opts()
    if opts.get("radiation_width") and not opts.get("radiation_speed"):
        model = model.with_(
            options={**opts, "radiation_speed": infer_radiation_speed(model.phys(), opts)}
        )
    grid = create_grid(model.grid_params, dtype, device=device)
    base_ctx = build_context(model, grid, dtype)
    n = model.num_ts if n_steps is None else int(n_steps)

    def fields_at(params: dict, phys0, steps):
        """The physical fields after each step count of ``steps`` (1 to
        n_steps), in increasing order, from one integration of ``phys0``."""
        want = sorted(set(int(k) for k in steps))
        if not want or want[0] < 1 or want[-1] > n:
            raise ValueError(f"steps must lie in 1..{n}, got {list(steps)}")
        if torch.is_tensor(phys0):
            phys0 = phys0.to(dtype=dtype, device=grid.device)
        else:
            phys0 = torch.as_tensor(np.asarray(phys0), dtype=dtype, device=grid.device)
        over = {k: v.to(grid.device) if torch.is_tensor(v) else v for k, v in params.items()}
        ctx = dataclasses.replace(
            base_ctx, params={**base_ctx.params, **over}, extras=dict(base_ctx.extras)
        )
        spec0 = grid.analysis(phys0)
        _set_boundary_refs(ctx, grid, spec0)
        step = build_step(model, grid, ctx, dtype)
        state = ti.initial_state(spec0, (grid.nvars,) + grid.spatial_shape, dtype)
        out = {}
        for i in range(1, want[-1] + 1):
            if remat and torch.is_grad_enabled():
                state = checkpoint(step, state, use_reentrant=False)
            else:
                state = step(state)
            if i in want:
                out[i] = grid.synthesis(state.spec)["val"]
        return [out[k] for k in want]

    def sim(params: dict, phys0):
        return fields_at(params, phys0, (n,))[0]

    sim.fields_at = fields_at
    return sim, grid, base_ctx


def adam(params, lr: float) -> torch.optim.Adam:
    """torch.optim.Adam with optax.adam's defaults (b1 0.9, b2 0.999, eps
    1e-8, no eps_root): the same update, mu_hat / (sqrt(nu_hat) + eps)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def cosine_decay(init_value: float, decay_steps: int):
    """optax.cosine_decay_schedule(init_value, decay_steps) (alpha 0): the
    learning rate of update ``count`` (0-based)."""

    def lr(count: int) -> float:
        c = min(count, decay_steps)
        return init_value * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))

    return lr


def fit_parameters(
    sim,
    init_params: dict,
    phys0,
    observations,
    *,
    steps: int = 100,
    learning_rate: float = 0.1,
    log_space: bool = True,
    obs_slice=None,
):
    """Recover physical parameters from observed final fields by Adam.

    Minimizes the mean-squared misfit between ``sim(params, phys0)`` and
    ``observations`` (optionally restricted to ``obs_slice``), normalized by
    the observations' mean square.  ``log_space=True`` optimizes
    ``log(param)``.  The parameters are packed in sorted name order into one
    float64 vector on the observations' device, as the JAX package packs
    them.  Returns ``(params, history)`` with the loss of every iteration
    (before its update)."""
    names = sorted(init_params)
    obs = torch.as_tensor(observations)
    vec = torch.tensor(
        [math.log(float(init_params[k])) if log_space else float(init_params[k])
         for k in names],
        dtype=torch.float64, device=obs.device, requires_grad=True,
    )

    def unpack(v):
        return {k: (torch.exp(v[i]) if log_space else v[i]) for i, k in enumerate(names)}

    def loss_fn(v):
        out = sim(unpack(v), phys0)
        if obs_slice is not None:
            out = out[obs_slice]
        o = obs.to(out.dtype)
        denom = torch.mean(o * o) + 1e-30
        return torch.mean((out - o) ** 2) / denom

    opt = adam([vec], learning_rate)
    history = []
    for _ in range(steps):
        opt.zero_grad()
        loss = loss_fn(vec)
        loss.backward()
        history.append(float(loss))
        opt.step()
    with torch.no_grad():
        return {k: float(v) for k, v in unpack(vec).items()}, history
