"""A cell, its configuration, traffic, driver and metric readers are found by
name, and so are the reference's grids, equation sets and options: those of
every cell of ``BENCHMARK.json`` and every option module there is."""

import importlib
import json
import pkgutil
import sys
import types

import pytest
import torch

from benchmark import harness
from benchmark.reference import config as rconfig
from benchmark.reference import equations, grid, stepper
from benchmark.reference import options as roptions
from benchmark.tests.conftest import CELLS


def cell_configs():
    return [harness.load_cell(cell)["cfg"] for cell in CELLS]


def equation_sets():
    """The equation sets of every cell and of its inputs' spin-up."""
    names = set()
    for cfg in cell_configs():
        names.add(cfg["model"]["equation_set"])
        spin = cfg.get("ics", {}).get("spinup")
        if spin:
            names.add(spin["equation_set"])
    return sorted(names)


def test_a_dummy_cell_is_found_by_name(tmp_path):
    for d in ("workloads", "configs", "traffic"):
        (tmp_path / d).mkdir()
    (tmp_path / "workloads" / "dummy.json").write_text(json.dumps(
        {"config": "dummy_cfg", "traffic": "dummy_mix", "chips": 1, "warmup_steps": 3,
         "checks": {"warmup_gap": {"limit": 1.0}}}))
    (tmp_path / "configs" / "dummy_cfg.json").write_text(json.dumps({"name": "dummy_cfg"}))
    (tmp_path / "traffic" / "dummy_mix.json").write_text(json.dumps({"dtype": "float64"}))
    cell = harness.load_cell("dummy", tmp_path)
    assert cell["name"] == "dummy" and cell["cfg"]["name"] == "dummy_cfg"
    assert cell["traffic_params"]["dtype"] == "float64"


def test_metric_readers_are_found_by_name():
    rec = harness.TraceRecord("float32", {"geometry": "RL", "V": 6, "R": 300, "L": 256,
                                          "B": 103, "Z": 0},
                              output_gaps_s=[0.25, 0.75], graph_info={"nodes": 148})
    assert harness.metric_reader("output_ms")(rec) == 500.0
    assert harness.metric_reader("graph_nodes")(rec) == 148
    # nothing traced: the device readers return nothing, never 0
    for name in ("gemm_us_step", "pointwise_us_step", "column_solve_roofline",
                 "rlz_analysis_roofline", "step_mfu", "idle_pct", "peak_mem_gb"):
        assert harness.metric_reader(name)(rec) is None
    # the window's idle share: 600 steps of 1 ms device time in a 1.5 s wall
    rec.step_device_s, rec.window_steps, rec.window_wall_s = 1e-3, 600, 1.5
    assert abs(harness.metric_reader("idle_pct")(rec) - 60.0) < 1e-9


def test_checks_read_their_gaps_and_limits():
    cell = {"checks": {"a": {"limit": 0.1}, "b": {"gaps": "a", "vars": ["v"], "limit": 0.01}}}
    checks = harness.checks_of(cell, {"a": {"u": 0.05, "v": 0.02}})
    assert checks["a"][:2] == (0.05, 0.1) and checks["b"][:2] == (0.02, 0.01)
    assert not harness.decide({"failed": 0}, checks)
    assert harness.decide({"failed": 0}, {"a": checks["a"]})
    assert not harness.decide({"failed": 1}, {"a": checks["a"]})
    assert not harness.decide({"failed": 0}, {})


def test_a_traffic_file_names_its_driver(monkeypatch):
    dummy = types.ModuleType("benchmark.drivers.dummy")
    monkeypatch.setitem(sys.modules, "benchmark.drivers.dummy", dummy)
    assert harness.load_driver({"traffic_params": {"driver": "dummy"}}) is dummy
    for cell in CELLS:
        c = harness.load_cell(cell)
        driver = harness.load_driver(c)
        assert driver.__name__ == f"benchmark.drivers.{c['traffic_params']['driver']}"
        assert callable(driver.Run)


def test_the_reference_finds_grids_equation_sets_and_options_by_name():
    for name in equation_sets():
        eqset = equations.equation_set(name)
        assert callable(eqset.tendency) and isinstance(eqset.OPTIONS, frozenset)
    with pytest.raises(ValueError, match="eqsets/NoSuchSet.py"):
        equations.equation_set("NoSuchSet")
    for cfg in cell_configs():
        assert callable(grid.geometry_module(cfg["model"]["grid"]["geometry"]).create)
    with pytest.raises(ValueError, match="grids/NoSuchGeometry.py"):
        grid.geometry_module("NoSuchGeometry")
    found = stepper.option_modules({"sponge_width": 1.0e4, "sponge_tau": 600.0,
                                    "semiimplicit": False, "no_such_option": True})
    assert sorted(found) == ["sponge_width"]
    assert found["sponge_width"].PARAMS == ("sponge_tau",)
    keys = {m.name.rsplit(".", 1)[1] for m in pkgutil.iter_modules(
        roptions.__path__, "benchmark.reference.options.")}
    for cfg in cell_configs():  # every option of a cell that has a module has one here
        assert set(stepper.option_modules(cfg["model"]["options"])) <= keys
    for key in sorted(keys):
        mod = stepper.option_modules({key: True})[key]
        assert mod.STAGE in stepper.STAGES and callable(mod.build)
        assert isinstance(mod.ORDER, int)


@pytest.mark.parametrize("cell", CELLS)
def test_an_option_the_reference_lacks_is_refused(cell, small_bench):
    cfg = harness.load_cell(cell, small_bench)["cfg"]
    eqset = equations.equation_set(cfg["model"]["equation_set"])
    # an option another cell's equation set reads and this one does not (the
    # moist sets read "smagorinsky", the slab none), or one that none reads
    others = set().union(*(equations.equation_set(n).OPTIONS for n in equation_sets()))
    lacking = sorted(others - eqset.OPTIONS - set(stepper.option_modules(
        dict.fromkeys(others, True))))
    key = lacking[0] if lacking else "no_such_option"
    cfg["model"]["options"] = {**cfg["model"]["options"], key: 0.2}
    m = harness.model_parameters(rconfig, cfg, out_dir="", ic_path="", ref_state_file="",
                                 n_steps=1, out_steps=1)
    g = grid.create_grid(m.grid_params, torch.float64, "cpu")
    with pytest.raises(ValueError, match=key):
        stepper.build_step(m, g, stepper.build_context(m, g, torch.float64), torch.float64)


def test_one_analysis_option_at_a_time(small_bench, monkeypatch):
    """Two modules of the closing analysis are refused, as two implicit ones
    are; ``build_context``'s options need no module."""
    twin = types.ModuleType("benchmark.reference.options.twin_analysis")
    twin.STAGE, twin.ORDER = "analysis", 1
    twin.build = importlib.import_module(
        "benchmark.reference.options.incremental_analysis").build
    monkeypatch.setitem(sys.modules, twin.__name__, twin)
    cfg = harness.load_cell(CELLS[0], small_bench)["cfg"]
    cfg["model"]["options"] = {"incremental_analysis": True, "twin_analysis": True}
    m = harness.model_parameters(rconfig, cfg, out_dir="", ic_path="", ref_state_file="",
                                 n_steps=1, out_steps=1)
    g = grid.create_grid(m.grid_params, torch.float64, "cpu")
    with pytest.raises(ValueError, match="one analysis option"):
        stepper.build_step(m, g, stepper.build_context(m, g, torch.float64), torch.float64)
    assert "exact_reference_state" in stepper.CONTEXT_OPTIONS


def test_grids_share_the_ports_structural_classes():
    """XYZ and SLZ take the RLZ paths, SL the RL ones, as in the port: the
    modal filter and the Smagorinsky length scales go by the class."""
    want = {"R": "R", "RL": "RL", "RZ": "RZ", "RLZ": "RLZ", "XYZ": "RLZ", "SL": "RL",
            "SLZ": "RLZ"}
    assert set(want) == set(harness.COORD_NAMES)
    for geometry, struct in want.items():
        g = grid.Grid(rconfig.GridParameters(geometry=geometry), torch.float64,
                      torch.device("cpu"))
        assert g._struct == struct
