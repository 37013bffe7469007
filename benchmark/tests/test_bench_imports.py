"""Nothing a run loads is JAX or the JAX package (top-level module names,
compared whole: ``scythe_tpu_torch`` is the port and passes), and the plain
reference loads nothing of the port either, for every cell of
``BENCHMARK.json`` and its configuration.  Each check runs in a fresh
interpreter."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.tests.conftest import CELLS

ROOT = Path(__file__).resolve().parents[2]

RUN = """
import json, sys, pathlib, torch
torch.set_num_threads(1)
from benchmark import run, harness, control
out = harness.run_cell(sys.argv[2], 7, 0.1, False, device="cpu",
                       bench_dir=pathlib.Path(sys.argv[1]))
print(json.dumps({"forbidden": run.forbidden_modules(),
                  "port": "scythe_tpu_torch" in {m.split(".")[0] for m in sys.modules},
                  "checks": sorted(out.checks)}))
"""

REFERENCE = """
import importlib, json, pkgutil, sys, numpy as np, torch
import benchmark.reference as reference
for m in pkgutil.walk_packages(reference.__path__, "benchmark.reference."):
    importlib.import_module(m.name)  # every grid, equation set and option
from benchmark.reference import config, grid, stepper
import benchmark.harness as harness
cfg = json.load(open(f"benchmark/configs/{sys.argv[1]}.json"))
cfg["model"]["grid"].update(cfg["small"]["grid"])
if "spinup" in cfg.get("ics", {}):
    cfg["ics"]["spinup"]["seconds"] = 10 * cfg["model"]["ts"]
inputs = importlib.import_module(f"benchmark.configs.{sys.argv[1]}")
m = harness.model_parameters(config, cfg, out_dir="", ic_path="", ref_state_file="",
                             n_steps=4, out_steps=4)
g = grid.create_grid(m.grid_params, torch.float64, "cpu")
phys0, ref_file = inputs.make_inputs(cfg, g, sys.argv[2], np.random.default_rng(3), "cpu")
m = harness.model_parameters(config, cfg, out_dir="", ic_path="", ref_state_file=ref_file,
                             n_steps=4, out_steps=4)
ctx = stepper.build_context(m, g, torch.float64)
st = stepper.run(stepper.build_step(m, g, ctx, torch.float64),
                 stepper.initialize(m, g, ctx, phys0, torch.float64), 4)
tops = {name.split(".")[0] for name in sys.modules}
print(json.dumps({"tops": sorted(tops & {"scythe_tpu_torch", "scythe_tpu", "jax", "jaxlib"}),
                  "t": st.t}))
"""


def _run(code, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code, *map(str, args)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_neither_jax_nor_the_jax_package(cell, small_bench):
    got = _run(RUN, small_bench, cell)
    assert got == {"forbidden": [], "port": True,
                   "checks": sorted(harness.load_cell(cell)["checks"])}


@pytest.mark.parametrize("config", sorted({harness.load_cell(c)["config"] for c in CELLS}))
def test_the_reference_loads_nothing_of_the_port(config, tmp_path):
    got = _run(REFERENCE, config, tmp_path)
    assert got == {"tops": [], "t": 5}


def test_forbidden_names_are_compared_whole():
    from benchmark.run import forbidden_modules

    assert forbidden_modules({"scythe_tpu_torch": 0, "scythe_tpu_torch.model": 0,
                              "jaxtyping": 0}) == []
    assert forbidden_modules({"scythe_tpu.model": 0, "jax": 0, "flax.linen": 0}) == [
        "flax", "jax", "scythe_tpu"]
