"""Model driver: build the step and run the time loop, in PyTorch.

The counterpart of ``scythe_tpu.model``.  Per step: synthesis -> pointwise
tendencies -> AB3/AI2* update -> (semi-implicit column solve) ->
(condensation adjustment) -> analysis.  Where the JAX package runs the
steps between outputs inside one ``lax.scan``, here they are a Python loop
of eager steps; the host touches data only at output boundaries (CSV write
+ NaN watchdog), the reference cadence (semiimplicit.jl:288-293).

Ported options: ``semiimplicit`` (constant ``si_mode`` only), ``si_scale``,
the equation-set hooks (``reference_quirks``, ``exact_vertical_pgf``,
``stiff_relaxation``, ``condensation``, ``condensation_rate_cap``,
``condensation_tau``, ``sedimentation``).  Every other option the JAX
``build_step`` reads raises NotImplementedError naming it.
"""

from __future__ import annotations

import logging
import os
import time as _time
from typing import Any

import numpy as np
import torch

from . import io as sio
from . import timeintegration as ti
from .config import ModelParameters
from .equations.common import EqContext, get_equation_set
from .grids.base import Grid, create_grid
from .physics import microphysics as mp
from .physics import reference_state as rsmod

log = logging.getLogger("scythe_tpu_torch")

# options of the JAX build_step / run loop that are not ported yet: each
# raises when it is switched on (a value that is not falsy)
_UNPORTED_OPTIONS = (
    "sponge_width",
    "sponge_top_width",
    "radiation_width",
    "modal_filter_tau",
    "surface_fluxes",
    "implicit_vdiff",
    "incremental_analysis",
    "topography_file",
    "checkpoint_interval",
    "write_spectral",
)

_NEEDS_CONDENSATION = (
    "BF02_test",
    "rainfall_test",
    "MoistEulerRLZ",
    "MoistEulerXYZ",
    "MoistEulerSLZ",
)


def _reject_unported(opts: dict) -> None:
    for name in _UNPORTED_OPTIONS:
        if opts.get(name):
            raise NotImplementedError(
                f"options[{name!r}] is not ported to scythe_tpu_torch yet"
            )
    if opts.get("output_format") == "nc":
        raise NotImplementedError(
            "options['output_format']='nc' is not ported to scythe_tpu_torch yet"
        )


def build_context(model: ModelParameters, grid: Grid, dtype) -> EqContext:
    ref = rsmod.build_reference_state(model, grid, dtype)
    return EqContext(
        grid=grid,
        coords=grid.coords(),
        params=model.phys(),
        options=model.opts(),
        ts=model.ts,
        var_index=grid.params.var_index,
        ref_state=ref,
    )


def build_step(model: ModelParameters, grid: Grid, ctx: EqContext, dtype):
    """Returns step(state) -> state."""
    eqset = get_equation_set(model.equation_set)
    if getattr(eqset, "geometry", None) and eqset.geometry != grid.geometry:
        raise ValueError(
            f"equation_set {model.equation_set!r} requires a "
            f"{eqset.geometry} grid, got {grid.geometry}"
        )
    opts = ctx.options
    _reject_unported(opts)
    p = grid.params
    semiimplicit = bool(opts.get("semiimplicit"))
    needs_condensation = model.equation_set in _NEEDS_CONDENSATION
    si_ops = None
    if semiimplicit:
        if ctx.ref_state is None:
            raise ValueError("semiimplicit integration requires a ref_state_file")
        si_mode = opts.get("si_mode", "constant")
        if si_mode not in ("constant", "variable"):
            raise ValueError(
                f"options['si_mode'] must be 'constant' or 'variable', "
                f"got {si_mode!r}"
            )
        si_scale = float(opts.get("si_scale", 1.0))
        si_ops = ti.build_semiimplicit_ops(
            p.zDim,
            p.zmin,
            p.zmax,
            p.b_zDim,
            si_scale * np.asarray(ctx.ref_state.Pxi_prof.cpu(), np.float64)
            if si_mode == "variable"
            else si_scale * float(ctx.ref_state.Pxi_bar),
            model.ts,
            dtype,
            grid.device,
        )
        w_i = p.var_index("w")
        xi_i = p.var_index("xi")

    ts = model.ts

    def step(state: ti.ModelState) -> ti.ModelState:
        fields = grid.synthesis(state.spec)
        res = eqset(fields, ctx)
        phys = fields["val"]
        if res.overrides:
            phys = phys.clone()  # fields["val"] is a view of a synthesis buffer
            for v, arr in res.overrides.items():
                phys[v] = arr
        var_np1, e_nm1, e_nm2 = ti.explicit_step(
            phys, res.expdot, state.expdot_nm1, state.expdot_nm2, state.t, ts
        )
        # var_np1 is a new tensor made by explicit_step, held by no history,
        # so the corrector and the condensation adjustment write into it in
        # place; the histories (state.*, res.expdot, res.impdot) are only
        # ever handed on
        impdot = res.impdot
        i_nm1, i_nm2 = state.impdot_nm1, state.impdot_nm2
        # slim implicit history: [[w, xi], *spatial]
        slim = (
            state.impdot_nm1.shape[0] == 2
            and state.impdot_nm1.shape != state.expdot_nm1.shape
        )
        if slim and not semiimplicit:
            raise ValueError(
                "slim impdot history (imp_rows=2) requires "
                "options['semiimplicit'] — use full-width initial_state"
            )
        if semiimplicit:
            hw, hx = (0, 1) if slim else (w_i, xi_i)
            w_new, xi_new = ti.semiimplicit_adjustment(
                si_ops,
                var_np1[w_i],
                var_np1[xi_i],
                impdot[w_i],
                state.impdot_nm1[hw],
                state.impdot_nm2[hw],
                impdot[xi_i],
                state.impdot_nm1[hx],
                state.impdot_nm2[hx],
                state.t,
            )
            var_np1[w_i] = w_new
            var_np1[xi_i] = xi_new
        if impdot is not None:
            i_n = torch.stack([impdot[w_i], impdot[xi_i]]) if slim else impdot
            i_nm1, i_nm2 = i_n, state.impdot_nm1
        if needs_condensation:
            var_np1 = mp.condensation_adjustment(var_np1, impdot, ctx)
        return ti.ModelState(
            spec=grid.analysis(var_np1),
            expdot_nm1=e_nm1,
            expdot_nm2=e_nm2,
            impdot_nm1=i_nm1,
            impdot_nm2=i_nm2,
            t=state.t + 1,
        )

    return step


def imp_history_rows(model: ModelParameters) -> int | None:
    """Implicit-history width for ti.initial_state: the slim 2-row [w, xi]
    layout for semi-implicit configurations, full width otherwise."""
    return 2 if model.opts().get("semiimplicit") else None


def initialize(model: ModelParameters, dtype=None, device: Any = "cpu"):
    """Build grid, context and initial state from the IC file on ``device``
    (ref initialize_model, semiimplicit.jl:126-193)."""
    dtype = dtype or torch.get_default_dtype()
    grid = create_grid(model.grid_params, dtype, device=device)
    ctx = build_context(model, grid, dtype)
    phys0 = sio.read_physical_grid(model.initial_conditions, grid)
    spec0 = grid.analysis(torch.as_tensor(phys0, dtype=dtype, device=grid.device))
    state = ti.initial_state(
        spec0,
        (grid.nvars,) + grid.spatial_shape,
        dtype,
        imp_rows=imp_history_rows(model),
    )
    return grid, ctx, state


def integrate_model(
    model: ModelParameters,
    dtype=None,
    write_outputs=True,
    resume_from: str | None = None,
    device: Any = "cpu",
):
    """Public driver (ref integrate_model, src/Scythe.jl:37-62).

    Runs ``integration_time / ts`` steps on ``device``, writing CSV output
    and running the NaN watchdog every ``output_interval`` (plus t=0 and the
    final time).  ``resume_from`` restarts from a checkpoint in the JAX
    package's ``.npz`` layout.  Returns (grid, final physical values
    [nvars, *spatial] as a numpy array)."""
    dtype = dtype or torch.get_default_dtype()
    with logged_run(model):
        t_setup = _time.time()
        grid, ctx, state = initialize(model, dtype, device)
        step = build_step(model, grid, ctx, dtype)
        return run_loop(
            model, grid, ctx, state, step, dtype,
            write_outputs=write_outputs, resume_from=resume_from,
            t_setup=t_setup,
        )


class logged_run:
    """Context manager: the ``scythe_out.log`` file handler in the output
    directory for the duration of a run."""

    def __init__(self, model: ModelParameters):
        self.model = model
        self.handler = None

    def __enter__(self):
        os.makedirs(self.model.output_dir, exist_ok=True)
        self.handler = logging.FileHandler(
            os.path.join(self.model.output_dir, "scythe_out.log")
        )
        log.addHandler(self.handler)
        log.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        log.removeHandler(self.handler)
        self.handler.close()
        return False


def run_loop(
    model: ModelParameters,
    grid,
    ctx,
    state,
    step,
    dtype,
    *,
    write_outputs=True,
    resume_from=None,
    t_setup=None,
):
    """The output/watchdog time loop (ref run_model + model_loop,
    src/semiimplicit.jl:219-293)."""
    t_setup = t_setup or _time.time()
    t_sim0 = 0.0
    if resume_from:
        state, t_sim0 = sio.load_checkpoint(resume_from, dtype, grid.device)
        log.info("Resumed from %s at t=%s (step %d)", resume_from, t_sim0, state.t)
    num_ts = model.num_ts
    output_int = max(1, min(model.output_int, num_ts))
    log.info(
        "Initialized %s on %s grid: %d vars, %s points, %d steps, %s",
        model.equation_set,
        grid.geometry,
        grid.nvars,
        grid.spatial_shape,
        num_ts,
        grid.device,
    )

    def fetch_phys(st):
        return grid.synthesis(st.spec)["val"].cpu().numpy()

    phys = fetch_phys(state)
    if write_outputs and not resume_from:
        sio.check_cfl(grid, phys)
        sio.write_output(grid, model, t_sim0, phys)
    log.info("Setup in %.2fs; starting integration", _time.time() - t_setup)

    t_run = _time.time()
    steps_done = 0
    while steps_done < num_ts:
        n = min(output_int, num_ts - steps_done)
        for _ in range(n):
            state = step(state)
        steps_done += n
        t_sim = t_sim0 + steps_done * model.ts
        phys = fetch_phys(state)  # the host copy waits for the device
        sio.check_cfl(grid, phys)
        if write_outputs:
            sio.write_output(grid, model, t_sim, phys)
        log.info("ts: %s", t_sim)
    wall = _time.time() - t_run
    log.info(
        "Done: %d steps in %.3fs (%.1f steps/s, wall clock incl. output)",
        num_ts,
        wall,
        num_ts / wall if wall > 0 else float("inf"),
    )
    return grid, phys
