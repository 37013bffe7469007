"""What the JW06 configuration (``jw06_production_slz``) adds to the plain
reference, held against the port's CPU path in float64 at the
configuration's ``small`` size: the del^4 term of ``MoistEulerSLZ`` alone
(the tendency with ``hyperdiffusion_k4`` less the tendency without it),
its stability guard, and the top sponge alone; the cell's inputs against
the port's own example; and, for every cell, the IC file's coordinate
columns as the program reads them.  The reader of ``hyperdiff_nodes``
reads the program's counter where it is and nothing where it is not."""

import json

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import grid as rgrid
from benchmark.reference import stepper as rstep
from benchmark.tests.conftest import CELLS

CELL = "jw06_production.f32"
F64 = torch.float64


def both_contexts(small_bench, tmp_path, **options):
    """The port's and the reference's (grid, ctx, fields of the initial
    state) of the small JW06 cell, its options updated by ``options``."""
    import scythe_tpu_torch.config as tconfig
    from scythe_tpu_torch import model as tmodel

    torch.set_num_threads(2)
    c = harness.load_cell(CELL, small_bench)
    c["cfg"]["model"]["options"].update(options)
    pr = harness.program_run(c, 2**31 + 21, tmp_path / "run", "cpu")
    pm = pr.model(tconfig, "port", 4, 4)
    grid, ctx, state = tmodel.initialize(pm, F64, "cpu")
    rm = pr.reference_model()
    rg = rgrid.create_grid(rm.grid_params, F64, "cpu")
    rctx = rstep.build_context(rm, rg, F64)
    rst = rstep.initialize(rm, rg, rctx, pr.phys0, F64)
    return (grid, ctx, grid.synthesis(state.spec)), (rg, rctx, rg.synthesis(rst.spec))


def tendency_gap(a, b):
    """max |a - b| / max |a| of two tendencies."""
    return float((a - b).abs().max() / a.abs().max())


def test_the_del4_term_alone_follows_the_port(small_bench, tmp_path):
    from scythe_tpu_torch.equations.common import get_equation_set

    from benchmark.reference.eqsets import MoistEulerSLZ as ref_set

    port_set = get_equation_set("MoistEulerSLZ")
    (grid, ctx, fields), (rg, rctx, rfields) = both_contexts(small_bench, tmp_path)
    k4 = ctx.options["hyperdiffusion_k4"]
    assert k4 == rctx.options["hyperdiffusion_k4"] == 6e16
    terms = []
    for eqset, c, f in ((port_set, ctx, fields), (ref_set.tendency, rctx, rfields)):
        with_k4 = eqset(f, c).expdot
        c.options["hyperdiffusion_k4"] = 0.0
        without = eqset(f, c).expdot
        c.options["hyperdiffusion_k4"] = k4
        terms.append(with_k4 - without)
    port_term, ref_term = terms
    assert port_term.abs().max() > 0
    assert tendency_gap(port_term, ref_term) <= 1e-12
    # the term is -K4 del^4 of every diffused variable through the grid's
    # own transforms
    a = rg.params.sphere_radius
    phi = rctx.coords["lat"]
    horiz = ref_set.horizontal_laplacian(rfields["dr"], rfields["drr"], rfields["dll"], a,
                                         torch.cos(phi), torch.tan(phi))
    mask = torch.ones(9, dtype=F64)
    mask[[1, 8]] = 0.0
    direct = -k4 * mask[:, None, None, None] * ref_set.hyperdiffusion(
        horiz, rg, a, torch.cos(phi), torch.tan(phi))
    assert tendency_gap(direct, ref_term) <= 1e-12


def test_the_del4_guard_refuses_what_the_ports_refuses(small_bench, tmp_path):
    from benchmark.reference.eqsets import MoistEulerSLZ as ref_set

    p = harness.load_cell(CELL)["cfg"]["model"]
    a, rdim = p["grid"]["sphere_radius"], 3 * p["grid"]["num_cells"]
    ref_set.del4_guard(p["options"]["hyperdiffusion_k4"], a, rdim, p["ts"])  # the recipe's
    with pytest.raises(ValueError, match="del\\^4 CFL"):
        ref_set.del4_guard(1.1 * p["options"]["hyperdiffusion_k4"], a, rdim, p["ts"])
    (grid, ctx, fields), (rg, rctx, rfields) = both_contexts(small_bench, tmp_path)
    from scythe_tpu_torch.equations.common import get_equation_set

    for eqset, c, f in ((get_equation_set("MoistEulerSLZ"), ctx, fields),
                        (ref_set.tendency, rctx, rfields)):
        c.options["hyperdiffusion_k4"] = 1.0e21
        with pytest.raises(ValueError, match="del\\^4 CFL"):
            eqset(f, c)


def test_the_top_sponge_alone_follows_the_port(small_bench, tmp_path):
    """Two steps of both with the sponge and without it: the sponge's share
    of the second step's tendency (the first step starts at the sponge's own
    reference) agrees."""
    import scythe_tpu_torch.config as tconfig
    from scythe_tpu_torch import model as tmodel

    shares = []
    for side in ("port", "reference"):
        got = []
        for sponge in (True, False):
            c = harness.load_cell(CELL, small_bench)
            if not sponge:
                for key in ("sponge_top_width", "sponge_top_tau"):
                    del c["cfg"]["model"]["options"][key]
            pr = harness.program_run(c, 2**31 + 21, tmp_path / f"{side}{sponge}", "cpu")
            if side == "port":
                pm = pr.model(tconfig, "port", 4, 4)
                grid, ctx, state = tmodel.initialize(pm, F64, "cpu")
                step = tmodel.build_step(pm, grid, ctx, F64)
            else:
                rm = pr.reference_model()
                grid = rgrid.create_grid(rm.grid_params, F64, "cpu")
                ctx = rstep.build_context(rm, grid, F64)
                state = rstep.initialize(rm, grid, ctx, pr.phys0, F64)
                step = rstep.build_step(rm, grid, ctx, F64)
            got.append(step(step(state)).spec)
        shares.append(got[0] - got[1])
    assert shares[0].abs().max() > 0
    assert tendency_gap(shares[0], shares[1]) <= 1e-9


def test_the_inputs_are_the_ports_example(tmp_path):
    """With the bump at its published place and size (no seeded move), the
    cell's inputs are the port's example's ``initial_fields`` on the same
    grid and reference column."""
    import scythe_tpu_torch as tx
    from scythe_tpu_torch import model as tmodel
    from scythe_tpu_torch.examples import jw06_baroclinic_slz as jw

    from benchmark.configs import jw06_production_slz as inputs

    c = harness.load_cell(CELL)
    cfg = json.loads(json.dumps(c["cfg"]))
    cfg["model"]["grid"].update(cfg["small"]["grid"])
    cfg["ics"]["perturbation"] = {"amp_frac": 0.0, "lon_deg": 0.0}
    from benchmark.reference import config as rconfig

    m = harness.model_parameters(rconfig, cfg, out_dir="", ic_path="", ref_state_file="",
                                 n_steps=1, out_steps=1)
    rg = rgrid.create_grid(m.grid_params, F64, "cpu")
    phys, _ = inputs.make_inputs(cfg, rg, str(tmp_path), np.random.default_rng(0), "cpu")
    g = cfg["model"]["grid"]
    pm = jw.build_model(str(tmp_path / "port"), num_cells=g["num_cells"], nl=g["lDim"],
                        zdim=g["zDim"], ts=7.5, l_q=0.0, sponge_top=12.0e3, k4=6.0e16,
                        smag=0.21)
    pg = tx.create_grid(pm.grid_params, F64, device="cpu")
    want = jw.initial_fields(pg, tmodel.build_context(pm, pg, F64).ref_state)
    for v in range(len(want)):
        scale = max(float(np.abs(want[v]).max()), 1.0)
        assert float(np.abs(phys[v] - want[v]).max()) <= 1e-12 * scale, v
    # a seed moves the bump
    moved, _ = inputs.make_inputs(c["cfg"] | {"model": cfg["model"]}, rg, str(tmp_path),
                                  np.random.default_rng(1), "cpu")
    assert np.abs(moved[3] - phys[3]).max() > 1e-3


@pytest.mark.parametrize("cell", CELLS)
def test_the_ic_file_has_the_geometrys_columns(cell, small_bench, tmp_path):
    import scythe_tpu_torch as tx
    import scythe_tpu_torch.config as tconfig
    from scythe_tpu_torch import io as sio

    c = harness.load_cell(cell, small_bench)
    pr = harness.program_run(c, 2**31 + 21, tmp_path / "run", "cpu")
    g = c["cfg"]["model"]["grid"]
    with open(pr.ic_path) as f:
        header = f.readline().strip().split(",")
    assert header == list(harness.COORD_NAMES[g["geometry"]]) + list(g["vars"])
    if g["geometry"] == "SLZ":
        assert header[:3] == ["lat", "lon", "z"]
    grid = tx.create_grid(pr.model(tconfig, "read", 1, 1).grid_params, F64, device="cpu")
    assert np.abs(sio.read_physical_grid(pr.ic_path, grid) - pr.phys0).max() == 0.0


def test_the_reader_reads_the_counter_where_it_is(monkeypatch):
    import sys

    from scythe_tpu_torch import trace

    read = harness.metric_reader("hyperdiff_nodes")
    rec = harness.TraceRecord("float32", {})
    monkeypatch.setattr(trace, "_process", trace.Record())
    assert read(rec) is None  # a step without the refit (the TC, Cha & Bell)
    trace.count("graph.nodes.tendency", 700)
    assert read(rec) is None
    trace.count("graph.nodes.hyperdiffusion", 42)
    assert read(rec) == 42
    # a program without the registry
    monkeypatch.setitem(sys.modules, "scythe_tpu_torch.trace", None)
    monkeypatch.delattr(sys.modules["scythe_tpu_torch"], "trace")
    assert read(rec) is None
