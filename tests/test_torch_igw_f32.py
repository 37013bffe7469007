"""The SK94 inertia-gravity wave in float32: the gap between the port and
the JAX package, and its cause (ROADMAP queue 3).

Both packages take 200 float32 steps of the published configuration (150
cells x 24 levels, ts 0.75 s) from one IC file on the CPU, each held to the
JAX package's float64 run.  The port's w drifts ~3.8x further than JAX's
(4,000 steps: correlation with the analytic field 0.697 against 0.845).
The step is the same op for op and its tendency is the same in float32; the
gap is the rounding of the radial contractions of the analysis and the
synthesis (sums of 450 and 153 terms, in the order the GEMM library
picks), which the wave's 0.01 K anomaly, 3e-5 of theta, magnifies: with
those sums accumulated in float64 (tools/torch_igw_f32_check.py's
``radial_in_f64``) the port's float32 run comes within JAX's error.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scythe_tpu as jx
from scythe_tpu import model as jmodel
from scythe_tpu_torch import model as tmodel
from test_torch_sharding import port_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 200
GAP_MAX = 6.0  # the port's float32 w error over JAX's: 3.76 when written
CAUSE_MAX = 1.25  # the same with the radial sums in float64: 0.72


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def w_errors(tmp_path_factory):
    torch.set_num_threads(2)
    igw = _load("igw_jax_f32", "examples/inertia_gravity_wave.py")
    tool = _load("torch_igw_f32_check", "tools/torch_igw_f32_check.py")
    model = igw.build_model(str(tmp_path_factory.mktemp("igw_f32")), 150, 24, 0.75,
                            STEPS * 0.75)
    g64 = jx.create_grid(model.grid_params, jnp.float64)
    igw.write_ics(model, g64, jmodel.build_context(model, g64, jnp.float64).ref_state)
    runs = {}
    for name, dt in (("jax f64", jnp.float64), ("jax f32", jnp.float32)):
        grid, ctx, state = jmodel.initialize(model, dt)
        state = jmodel.make_scan(jmodel.build_step(model, grid, ctx, dt), STEPS)(state)
        runs[name] = np.asarray(grid.synthesis(state.spec)["val"], np.float64)
    pm = port_model(model)
    for name, radial in (("port f32", False), ("port f32 radial f64", True)):
        with tool.radial_in_f64(radial):
            grid, ctx, state = tmodel.initialize(pm, torch.float32, device="cpu")
            step = tmodel.build_step(pm, grid, ctx, torch.float32)
            state = tmodel.make_scan(step, STEPS)(state)
            runs[name] = grid.synthesis(state.spec)["val"].double().numpy()
    w = grid.params.var_index("w")
    ref = runs.pop("jax f64")[w]
    return {k: float(np.abs(v[w] - ref).max() / np.abs(ref).max()) for k, v in runs.items()}


def test_igw_f32_gap_against_jax_is_bounded(w_errors):
    """The gap is read, not closed: the port's float32 w error after 200
    steps stays within GAP_MAX of JAX's."""
    ratio = w_errors["port f32"] / w_errors["jax f32"]
    assert ratio <= GAP_MAX, (ratio, w_errors)


def test_igw_f32_gap_is_the_radial_sums_rounding(w_errors):
    """With the radial contractions accumulated in float64, the port's
    float32 run is as close to JAX's float64 as JAX's own float32 run."""
    ratio = w_errors["port f32 radial f64"] / w_errors["jax f32"]
    assert ratio <= CAUSE_MAX, (ratio, w_errors)
