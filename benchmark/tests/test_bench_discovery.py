"""A cell, its configuration, traffic, driver and metric readers are found by
name, and so are the reference's grids, equation sets and options."""

import json
import sys
import types

import pytest
import torch

from benchmark import harness
from benchmark.reference import config as rconfig
from benchmark.reference import equations, grid, stepper


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
    for cell in ("tc_mature.f32", "cha_bell.f32"):
        assert harness.load_driver(harness.load_cell(cell)).__name__ == (
            "benchmark.drivers.run_loop")


def test_the_reference_finds_grids_equation_sets_and_options_by_name():
    for name in ("MoistEulerRLZ", "Twoway_ShallowWater_Slab", "Oneway_ShallowWater_Slab"):
        eqset = equations.equation_set(name)
        assert callable(eqset.tendency) and isinstance(eqset.OPTIONS, frozenset)
    with pytest.raises(ValueError, match="eqsets/NoSuchSet.py"):
        equations.equation_set("NoSuchSet")
    for geometry in ("RL", "RLZ"):
        assert callable(grid.geometry_module(geometry).create)
    with pytest.raises(ValueError, match="grids/XYZ.py"):
        grid.geometry_module("XYZ")
    found = stepper.option_modules({"sponge_width": 1.0e4, "sponge_tau": 600.0,
                                    "semiimplicit": False, "no_such_option": True})
    assert sorted(found) == ["sponge_width"]
    assert found["sponge_width"].PARAMS == ("sponge_tau",)
    for key in ("semiimplicit", "surface_fluxes", "implicit_vdiff", "sponge_width"):
        mod = stepper.option_modules({key: True})[key]
        assert mod.STAGE in stepper.STAGES and callable(mod.build)


def test_an_option_the_reference_lacks_is_refused(small_bench):
    cfg = harness.load_cell("cha_bell.f32", small_bench)["cfg"]
    cfg["model"]["options"] = {"smagorinsky": 0.2}  # the moist sets read it, the slab none
    m = harness.model_parameters(rconfig, cfg, out_dir="", ic_path="", ref_state_file="",
                                 n_steps=1, out_steps=1)
    g = grid.create_grid(m.grid_params, torch.float64, "cpu")
    with pytest.raises(ValueError, match="smagorinsky"):
        stepper.build_step(m, g, stepper.build_context(m, g, torch.float64), torch.float64)
