#!/usr/bin/env python3
"""The SK94 inertia-gravity wave in float32 in both packages, on the CPU:
the JAX example (examples/inertia_gravity_wave.py, 150 x 24, ts 0.75 s) and
the port's (scythe_tpu_torch/examples/inertia_gravity_wave.py) run from one
IC file for ``--steps`` steps in float32 and float64, each field's error
against the JAX float64 run (relative to that run's max), and with
``--steps 4000`` the test's readings (correlation with the analytic field,
energy centroid).  Its 0.01 K anomaly is 3e-5 of theta, a few float32
roundings, which is why chip_smoke.py holds the SK94 gate in float64.

One more run, "port f32 radial f64", is the port's float32 run with the
radial contractions of every analysis and synthesis (the 450- and 153-term
sums) accumulated in float64 and rounded to float32: it separates the
rounding of those sums, whose order the GEMM library picks, from the rest
of the step.

    python3 tools/torch_igw_f32_check.py [--steps 200] [--threads 4]

Prints one JSON object.  A development tool; it imports both packages, so
it runs where jax is installed (not on the card's machine).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


RADIAL_SUBS = ("vbr,", "drb,", "rb,")  # Grid._mm's radial contractions


@contextlib.contextmanager
def radial_in_f64(on):
    """While ``on``, the port's Grid._mm accumulates the radial contractions
    of a float32 grid in float64 and rounds the result to float32."""
    from scythe_tpu_torch.grids.base import Grid

    orig = Grid._mm

    def _mm(self, subs, op, x):
        if x.dtype == torch.float32 and subs.startswith(RADIAL_SUBS):
            return torch.einsum(subs, op.double(), x.double()).float()
        return orig(self, subs, op, x)

    if on:
        Grid._mm = _mm
    try:
        yield
    finally:
        Grid._mm = orig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from scythe_tpu import create_grid
    from scythe_tpu.model import build_context, build_step, initialize, make_scan
    from scythe_tpu_torch import model as tmodel
    from test_torch_sharding import port_model

    torch.set_num_threads(args.threads)
    spec = importlib.util.spec_from_file_location(
        "igw_jax", os.path.join(ROOT, "examples", "inertia_gravity_wave.py"))
    igw = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(igw)
    model = igw.build_model(tempfile.mkdtemp(prefix="igw_f32_"), 150, 24, 0.75,
                            args.steps * 0.75)
    g64 = create_grid(model.grid_params, jnp.float64)
    igw.write_ics(model, g64, build_context(model, g64, jnp.float64).ref_state)
    runs = {}
    for name, dt in (("jax f64", jnp.float64), ("jax f32", jnp.float32)):
        grid, ctx, state = initialize(model, dt)
        state = make_scan(build_step(model, grid, ctx, dt), args.steps)(state)
        runs[name] = np.asarray(grid.synthesis(state.spec)["val"], np.float64)
    pm = port_model(model)
    for name, dt in (("port f64", torch.float64), ("port f32", torch.float32),
                     ("port f32 radial f64", torch.float32)):
        with radial_in_f64(name.endswith("radial f64")):
            grid, ctx, state = tmodel.initialize(pm, dt, device="cpu")
            state = tmodel.make_scan(tmodel.build_step(pm, grid, ctx, dt), args.steps)(state)
            runs[name] = grid.synthesis(state.spec)["val"].double().numpy()
    ref = runs["jax f64"]
    # the radial analysis contraction alone, on the same float32 operands
    # (the JAX float64 run's final fields): each library's error against
    # the float64 sum, relative to each field's max
    op = np.asarray(create_grid(model.grid_params, jnp.float32).analysis_r)
    x = ref.astype(np.float32)
    exact = np.einsum("vbr,vrz->vbz", op.astype(np.float64), x.astype(np.float64))
    sums = {"jax": np.asarray(jnp.einsum("vbr,vrz->vbz", jnp.asarray(op), jnp.asarray(x))),
            "torch": torch.einsum("vbr,vrz->vbz", torch.from_numpy(op.copy()),
                                  torch.from_numpy(x.copy())).numpy()}
    out = {"steps": args.steps, "radial_analysis_sum_rel_err": {
        k: {n: float(np.abs(v[i] - exact[i]).max() / np.abs(exact[i]).max())
            for i, n in ((0, "s"), (1, "xi"), (3, "u"), (4, "w"))}
        for k, v in sums.items()}, "rel_err_vs_jax_f64": {
        k: dict(zip(("s", "xi", "mu", "u", "w"),
                    (float(np.abs(v[i] - ref[i]).max() / np.abs(ref[i]).max())
                     for i in range(5))))
        for k, v in runs.items() if k != "jax f64"}}
    if args.steps * 0.75 == 3000.0:
        ctx64 = build_context(model, g64, jnp.float64)
        th_an = igw.analytic_theta_pert(g64, 3000.0)
        out["readings"] = {}
        for k, v in runs.items():
            thp = igw.theta_pert(v, g64, ctx64.ref_state)
            out["readings"][k] = {
                "corr": float((thp * th_an).sum() / np.sqrt((thp**2).sum() * (th_an**2).sum())),
                "centroid_m": float(igw.energy_centroid_x(thp, g64)),
                "analytic_centroid_m": float(igw.energy_centroid_x(th_an, g64))}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
