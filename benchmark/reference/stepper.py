"""The model step, frozen from the port for the benchmark's reference:
``scythe_tpu_torch/timeintegration.py``'s AB3 with its start-up ramp and
``scythe_tpu_torch/model.py``'s ``build_step``, assembled from the equation
set (``eqsets/<equation_set>.py``) and one module an option
(``options/<key>.py``), both found by name.  An option module has
``STAGE``, ``ORDER`` and ``build(model, grid, ctx, dtype)``, which returns
the stage's hook.  The stages follow the port's step:

- ``"tendency"``: ``hook(expdot, phys, fields) -> expdot``, after the
  equation set, in ``ORDER`` (``fields`` the step's synthesis, every
  derivative slot, for an option such as the radiating boundary that reads
  one);
- ``"implicit"``: ``hook(var_np1, res, state) -> (var_np1, impdot_nm1,
  impdot_nm2)``, after AB3, at most one;
- ``"update"``: ``hook(var_np1, res) -> var_np1``, after the implicit
  stage, in ``ORDER``, before the equation set's ``after_update``;
- ``"analysis"``: ``hook(state, fields, var_np1) -> spec``, the step's
  closing analysis (``fields`` the step's synthesis), at most one; without
  one the step closes with ``grid.analysis(var_np1)``;
- ``"filter"``: ``hook(spec) -> spec``, after the analysis, in ``ORDER``;

and may have ``PARAMS`` (further option keys it reads), ``IMP_ROWS`` (the
rows its implicit histories keep) and ``on_initialize(ctx, grid, spec0)``.
The options ``build_context`` reads (``CONTEXT_OPTIONS``) need no module.

``run`` advances a state by ``n`` steps: eagerly, or on a CUDA device with
the steady step replayed as one CUDA graph (t = 1, 2 eager), so that the
reference follows an output interval in a few seconds.
"""

from __future__ import annotations

import importlib
from typing import NamedTuple

import numpy as np
import torch

from . import reference_state as rsmod
from .equations import EqContext, equation_set

STAGES = ("tendency", "implicit", "update", "analysis", "filter")
# options read by build_context (the reference state it builds), not by an
# equation set or an option module
CONTEXT_OPTIONS = ("exact_reference_state",)


class ModelState(NamedTuple):
    """The port's state layout: spectral coefficients and the physical
    tendency histories (the implicit ones slim [[w, xi], ...] where the run
    is semi-implicit); ``t`` the 1-based index of the next step."""

    spec: torch.Tensor
    expdot_nm1: torch.Tensor
    expdot_nm2: torch.Tensor
    impdot_nm1: torch.Tensor
    impdot_nm2: torch.Tensor
    t: int


def initial_state(spec, phys_shape, dtype, imp_rows=None) -> ModelState:
    z = torch.zeros(tuple(phys_shape), dtype=dtype, device=spec.device)
    zi = z if imp_rows is None else torch.zeros(
        (imp_rows,) + tuple(phys_shape[1:]), dtype=dtype, device=spec.device)
    return ModelState(spec, z, z, zi, zi, 1)


def explicit_step(phys, expdot_n, expdot_nm1, expdot_nm2, t: int, ts: float):
    if t == 1:
        var_np1 = phys + ts * expdot_n
    elif t == 2:
        var_np1 = phys + (0.5 * ts) * (3.0 * expdot_n - expdot_nm1)
    else:
        var_np1 = phys + (ts / 12.0) * (
            23.0 * expdot_n - 16.0 * expdot_nm1 + 5.0 * expdot_nm2
        )
    return var_np1, expdot_n, expdot_nm1


def build_context(model, grid, dtype) -> EqContext:
    ref = rsmod.build_reference_state(model, grid, dtype)
    return EqContext(grid=grid, coords=grid.coords(), params=model.phys(),
                     options=model.opts(), ts=model.ts,
                     var_index=grid.params.var_index, ref_state=ref)


def option_modules(opts: dict) -> dict:
    """{key: module} of the options set (truthy) in ``opts`` that have a
    module ``benchmark/reference/options/<key>.py``."""
    found = {}
    for key, value in opts.items():
        name = f"{__package__}.options.{key}"
        if not value or not key.isidentifier():
            continue
        try:
            found[key] = importlib.import_module(name)
        except ModuleNotFoundError as e:
            if e.name != name:
                raise
    return found


def build_step(model, grid, ctx: EqContext, dtype):
    """step(state) -> state, as the port's ``build_step``: the synthesis, the
    equation set's tendency, the tendency options, AB3, the implicit option
    (or the histories kept as they come), the update options, the equation
    set's adjustment, the analysis option (or ``grid.analysis``) and the
    filter options.  An option that neither the equation set, nor
    ``build_context``, nor a module of ``options/`` reads is refused."""
    opts = ctx.options
    eqset = equation_set(model.equation_set)
    mods = option_modules(opts)
    handled = set(eqset.OPTIONS) | set(CONTEXT_OPTIONS) | set(mods) | {
        k for m in mods.values() for k in getattr(m, "PARAMS", ())}
    unknown = {k for k, v in opts.items() if v and k not in handled}
    if unknown:
        raise ValueError(f"the reference does not implement options {sorted(unknown)}")
    hooks = {stage: [m.build(model, grid, ctx, dtype) for m in
                     sorted((m for m in mods.values() if m.STAGE == stage),
                            key=lambda m: m.ORDER)]
             for stage in STAGES}
    for stage in ("implicit", "analysis"):
        if len(hooks[stage]) > 1:
            raise ValueError(f"the reference takes one {stage} option at a time")
    implicit = hooks["implicit"][0] if hooks["implicit"] else keep_histories
    close = hooks["analysis"][0] if hooks["analysis"] else (
        lambda state, fields, var_np1: grid.analysis(var_np1))
    after_update = getattr(eqset, "after_update", None)
    ts = model.ts

    def step(state: ModelState) -> ModelState:
        fields = grid.synthesis(state.spec)
        res = eqset.tendency(fields, ctx)
        phys = fields["val"]
        if res.overrides:
            phys = phys.clone()
            for v, arr in res.overrides.items():
                phys[v] = arr
        expdot = res.expdot
        for hook in hooks["tendency"]:
            expdot = hook(expdot, phys, fields)
        var_np1, e_nm1, e_nm2 = explicit_step(
            phys, expdot, state.expdot_nm1, state.expdot_nm2, state.t, ts)
        var_np1, i_nm1, i_nm2 = implicit(var_np1, res, state)
        for hook in hooks["update"]:
            var_np1 = hook(var_np1, res)
        if after_update is not None:
            var_np1 = after_update(var_np1, res.impdot, ctx)
        spec = close(state, fields, var_np1)
        for hook in hooks["filter"]:
            spec = hook(spec)
        return ModelState(spec, e_nm1, e_nm2, i_nm1, i_nm2, state.t + 1)

    return step


def keep_histories(var_np1, res, state):
    """The implicit stage with no implicit option: the equation set's
    implicit tendency, if it has one, joins the histories."""
    if res.impdot is None:
        return var_np1, state.impdot_nm1, state.impdot_nm2
    return var_np1, res.impdot, state.impdot_nm1


def initialize(model, grid, ctx: EqContext, phys0: np.ndarray, dtype) -> ModelState:
    """The state of the physical fields ``phys0`` [nvars, *spatial]; each
    option with an ``on_initialize`` sets what it keeps on ``ctx``."""
    spec0 = grid.analysis(torch.as_tensor(phys0, dtype=dtype, device=grid.device))
    mods = option_modules(ctx.options)
    for m in mods.values():
        if hasattr(m, "on_initialize"):
            m.on_initialize(ctx, grid, spec0)
    imp_rows = next((m.IMP_ROWS for m in mods.values() if hasattr(m, "IMP_ROWS")), None)
    return initial_state(spec0, (grid.nvars,) + grid.spatial_shape, dtype, imp_rows)


def run(step, state: ModelState, n: int) -> ModelState:
    """``n`` steps of ``step`` from ``state``; on a card the steady steps
    replay one CUDA graph of the step, captured here from a warm-up step."""
    while n and (state.t <= 2 or state.spec.device.type != "cuda"):
        state = step(state)
        n -= 1
    if not n:
        return state
    bufs = [t.clone() for t in state[:5]]
    t0 = state.t

    def body():
        out = step(ModelState(*bufs, t0))
        news = [o.clone() for o in out[:5]]  # every output apart from the inputs
        for b, o in zip(bufs, news):
            b.copy_(o)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()  # the warm-up: a real step
    torch.cuda.current_stream().wait_stream(side)
    n -= 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    for _ in range(n):
        graph.replay()
    out = ModelState(*(b.clone() for b in bufs), t0 + 1 + n)
    torch.cuda.synchronize()
    del graph
    return out
