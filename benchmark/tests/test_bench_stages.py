"""The reference's closing stages and the options the port's step reads
around them, against the port's CPU path in float64 on the small cells
(``small_bench``): the incremental closing analysis, the modal filter,
``si_scale`` and the exact reference state, one at a time and together, each
within 1e-12 a step of the port over ``STEPS`` steps, as
``test_bench_reference.py`` holds the cells' own options.  Without them the
step is bit for bit the one assembled from the stages the reference had
before the analysis and filter stages (tendency, implicit, update)."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import chebyshev
from benchmark.reference import equations
from benchmark.reference import grid as rgrid
from benchmark.reference import reference_state as rsmod
from benchmark.reference import stepper as rstep
from benchmark.tests.conftest import CELLS
from benchmark.tests.test_bench_reference import STEPS

TC = "tc_mature.f32"
FILTER = {"modal_filter_tau": 30.0}
OPTIONS = {
    "incremental_analysis": {"incremental_analysis": True},
    "modal_filter_rlz": FILTER,
    "modal_filter_l8": {**FILTER, "modal_filter_axes": "l", "modal_filter_order": 8},
    "si_scale": {"si_scale": 1.5},
    "exact_reference_state": {"exact_reference_state": True},
    "together": {"incremental_analysis": True, **FILTER, "si_scale": 1.5,
                 "exact_reference_state": True},
}
# the closing stages on every other cell's own grid and options (the TC's
# cases hold si_scale and the exact reference state, which read its sounding)
CLOSING = {"incremental_analysis": True, **FILTER}


def exact_reference_file(path, sounding, p):
    """The reference columns interpolated from ``sounding``, written as a
    pre-balanced state on the model levels ('z sbar xibar mubar mu_lbar')."""
    rs = rsmod.interpolate_reference_file(sounding, p["zmin"], p["zmax"], p["zDim"],
                                          chebyshev.b_zdim(p["zDim"]), torch.float64,
                                          device="cpu")
    z = chebyshev.build_ops(p["zDim"], p["zmin"], p["zmax"], chebyshev.b_zdim(p["zDim"])).points
    cols = [z] + [a[:, 0].numpy() for a in (rs.sbar, rs.xibar, rs.mubar, rs.mu_lbar)]
    np.savetxt(path, np.stack(cols, axis=1), fmt="%.17g")
    return str(path)


def both_sides(cell, opts, bench, tmp_path, drop=()):
    """The port's and the reference's (state, step) in float64 on the CPU,
    the cell's options updated by ``opts``, those in ``drop`` taken out."""
    import scythe_tpu_torch.config as tconfig
    from scythe_tpu_torch import model as tmodel

    torch.set_num_threads(2)
    c = harness.load_cell(cell, bench)
    options = c["cfg"]["model"]["options"]
    options.update(opts)
    for key in drop:
        options.pop(key, None)
    pr = harness.program_run(c, 20240611, tmp_path / "run", "cpu")
    if opts.get("exact_reference_state"):
        pr.ref_state_file = exact_reference_file(tmp_path / "exact.txt", pr.ref_state_file,
                                                 c["cfg"]["model"]["grid"])
    f64 = torch.float64
    pm = pr.model(tconfig, "port", STEPS, STEPS)
    grid, ctx, pstate = tmodel.initialize(pm, f64, "cpu")
    pstep = tmodel.build_step(pm, grid, ctx, f64)
    rm = pr.reference_model()
    rg = rgrid.create_grid(rm.grid_params, f64, "cpu")
    rctx = rstep.build_context(rm, rg, f64)
    rst = rstep.initialize(rm, rg, rctx, pr.phys0, f64)
    return (pstate, pstep), (rst, rstep.build_step(rm, rg, rctx, f64)), (rm, rg, rctx)


@pytest.mark.parametrize("cell, case", [(TC, case) for case in OPTIONS] + [
    (cell, "closing") for cell in CELLS if cell != TC])
def test_the_reference_follows_the_port_with_the_closing_options(cell, case, small_bench,
                                                                 tmp_path):
    opts = OPTIONS[case] if cell == TC else CLOSING
    (pstate, pstep), (rst, rs), _ = both_sides(cell, opts, small_bench, tmp_path)
    np.testing.assert_allclose(rst.spec.numpy(), pstate.spec.numpy(), rtol=0, atol=1e-12)
    for _ in range(STEPS):
        pstate, rst = pstep(pstate), rs(rst)
        scale = pstate.spec.abs().amax(dim=tuple(range(1, pstate.spec.ndim)), keepdim=True)
        gap = ((pstate.spec - rst.spec).abs() / scale.clamp_min(1e-300)).max().item()
        assert gap <= 1e-12, gap


def parent_step(model, grid, ctx, dtype):
    """The step as the reference assembled it with the stages tendency,
    implicit and update, closing with ``grid.analysis``."""
    eqset = equations.equation_set(model.equation_set)
    mods = rstep.option_modules(ctx.options)
    hooks = {stage: [m.build(model, grid, ctx, dtype) for m in
                     sorted((m for m in mods.values() if m.STAGE == stage),
                            key=lambda m: m.ORDER)]
             for stage in ("tendency", "implicit", "update")}
    implicit = hooks["implicit"][0] if hooks["implicit"] else rstep.keep_histories
    after_update = getattr(eqset, "after_update", None)

    def step(state):
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
        var_np1, e_nm1, e_nm2 = rstep.explicit_step(
            phys, expdot, state.expdot_nm1, state.expdot_nm2, state.t, model.ts)
        var_np1, i_nm1, i_nm2 = implicit(var_np1, res, state)
        for hook in hooks["update"]:
            var_np1 = hook(var_np1, res)
        if after_update is not None:
            var_np1 = after_update(var_np1, res.impdot, ctx)
        return rstep.ModelState(grid.analysis(var_np1), e_nm1, e_nm2, i_nm1, i_nm2,
                                state.t + 1)

    return step


@pytest.mark.parametrize("cell", CELLS)
def test_without_them_the_step_is_the_parents_bit_for_bit(cell, small_bench, tmp_path):
    """The cell as it is, less any option of the analysis and filter stages
    it sets (today's cells set none)."""
    options = harness.load_cell(cell)["cfg"]["model"]["options"]
    drop = [k for k, m in rstep.option_modules(options).items()
            if m.STAGE in ("analysis", "filter")]
    drop += [k for k in options if k.startswith("modal_filter_")]
    _, (state, step), (rm, rg, rctx) = both_sides(cell, {}, small_bench, tmp_path, drop)
    old = parent_step(rm, rg, rctx, torch.float64)
    new_state = old_state = state
    for _ in range(STEPS):
        new_state, old_state = step(new_state), old(old_state)
    assert new_state.t == old_state.t == STEPS + 1
    for a, b in zip(new_state[:5], old_state[:5]):
        assert torch.equal(a, b)
