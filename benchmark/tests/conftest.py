"""Settings of the benchmark's own tests: ``python -m pytest benchmark/tests``.

Tests that need a CUDA card carry the ``chip`` marker and take the ``card``
fixture, which skips them where torch sees no card; the decision is made
when the test runs, never while the module is imported.  On a card machine:
``python -m pytest benchmark/tests -m chip``.

The tests of a cell take their cells from ``BENCHMARK.json`` (``CELLS``),
so that a cell added there with its files is tested with no edit here; each
cell runs at the size its configuration's ``small`` key gives.
"""

import json
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in json.loads((BENCH.parent / "BENCHMARK.json").read_text())[
    "workloads"]]


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return "cuda"


@pytest.fixture
def small_bench(tmp_path):
    """A benchmark folder of every cell of ``BENCHMARK.json`` at a size a test
    run holds: each configuration's grid and output interval as its
    ``small`` key gives them (an output every few steps), five warm-up
    steps, ten steps of spin-up in the inputs; the traffic and the limits
    as the cells' own."""
    for d in ("workloads", "configs", "traffic"):
        (tmp_path / d).mkdir()
    for cell in CELLS:
        c = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
        shutil.copy(BENCH / "traffic" / f"{c['traffic']}.json", tmp_path / "traffic")
        cfg = json.loads((BENCH / "configs" / f"{c['config']}.json").read_text())
        small = cfg["small"]
        cfg["model"]["grid"].update(small["grid"])
        out_s = small["output_interval"]
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
