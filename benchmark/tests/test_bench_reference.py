"""The plain reference (``benchmark/reference``) against the port's CPU path:
a few steps of each equation set and options the cells of ``BENCHMARK.json``
run (and the equation set of their inputs' spin-up, such as Cha & Bell's
one-way set) at a small grid, in float64, from the same inputs: the
start-up steps (t = 1, 2) and AB3."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import grid as rgrid
from benchmark.reference import stepper as rstep
from benchmark.tests.conftest import CELLS

STEPS = 6


def equation_set_cases():
    """(cell, None) for each cell's own equation set, and (cell, set) for the
    set of its inputs' spin-up, where it has one."""
    for cell in CELLS:
        yield cell, None
        spin = harness.load_cell(cell)["cfg"].get("ics", {}).get("spinup")
        if spin:
            yield cell, spin["equation_set"]


@pytest.mark.parametrize("cell, equation_set", list(equation_set_cases()))
def test_reference_follows_the_port(cell, equation_set, small_bench, tmp_path):
    import scythe_tpu_torch.config as tconfig
    from scythe_tpu_torch import model as tmodel

    torch.set_num_threads(2)
    c = harness.load_cell(cell, small_bench)
    if equation_set:
        c["cfg"]["model"]["equation_set"] = equation_set
    pr = harness.program_run(c, 20240611, tmp_path / "run", "cpu")
    f64 = torch.float64
    pm = pr.model(tconfig, "port", STEPS, STEPS)
    grid, ctx, pstate = tmodel.initialize(pm, f64, "cpu")
    pstep = tmodel.build_step(pm, grid, ctx, f64)
    rm = pr.reference_model()
    rg = rgrid.create_grid(rm.grid_params, f64, "cpu")
    rctx = rstep.build_context(rm, rg, f64)
    rst = rstep.initialize(rm, rg, rctx, pr.phys0, f64)
    rs = rstep.build_step(rm, rg, rctx, f64)
    np.testing.assert_allclose(rst.spec.numpy(), pstate.spec.numpy(), rtol=0, atol=1e-12)
    for _ in range(STEPS):
        pstate, rst = pstep(pstate), rs(rst)
        scale = pstate.spec.abs().amax(dim=tuple(range(1, pstate.spec.ndim)), keepdim=True)
        gap = ((pstate.spec - rst.spec).abs() / scale.clamp_min(1e-300)).max().item()
        assert gap <= 1e-12, gap
    assert np.abs(rg.gridpoints() - grid.gridpoints()).max() == 0.0
