"""Settings of the benchmark's own tests: ``python -m pytest benchmark/tests``.

Tests that need a CUDA card carry the ``chip`` marker and take the ``card``
fixture, which skips them where torch sees no card; the decision is made
when the test runs, never while the module is imported.  On a card machine:
``python -m pytest benchmark/tests -m chip``.
"""

import json
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return "cuda"


SMALL = {"tc_mature.f32": ({"num_cells": 10, "zDim": 12}, 20.0),
         "cha_bell.f32": ({"num_cells": 12, "lDim": 32}, 30.0)}


@pytest.fixture
def small_bench(tmp_path):
    """A benchmark folder of the two cells at a size a test run holds: the
    configurations' grids shrunk, an output every ten steps, five warm-up
    steps, ten steps of spin-up in the inputs; the limits as the cells'
    own."""
    for d in ("workloads", "configs", "traffic"):
        (tmp_path / d).mkdir()
    shutil.copy(BENCH / "traffic" / "integrate_f32.json", tmp_path / "traffic")
    for cell, (grid, out_s) in SMALL.items():
        c = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
        cfg = json.loads((BENCH / "configs" / f"{c['config']}.json").read_text())
        cfg["model"]["grid"].update(grid)
        cfg["model"]["output_interval"] = out_s
        cfg["model"]["integration_time"] = 100 * out_s
        cfg["inputs"] = c["config"]
        if "spinup" in cfg.get("ics", {}):
            cfg["ics"]["spinup"]["seconds"] = 10 * cfg["model"]["ts"]
        c["config"] = cfg["name"] = "small_" + c["config"]
        c.update(warmup_steps=5, trace_steps=5)
        (tmp_path / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        (tmp_path / "workloads" / f"{cell}.json").write_text(json.dumps(c))
    return tmp_path
