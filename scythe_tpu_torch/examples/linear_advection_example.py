"""Linear advection walk-through, in PyTorch: the port of
``examples/linear_advection_example.py`` (ref
notebooks/LinearAdvection_example.ipynb).

Advect a Gaussian around a periodic 100 m domain (R grid, 100 cells,
LinearAdvection1D) for one full period, 2,000 steps of 0.05 s, and report
the L2 difference from the initial state ("should be small").

Run:  python -m scythe_tpu_torch.examples.linear_advection_example [--cpu]
      [--dir DIR]
(float32 on the card, float64 with --cpu.)
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import BC, GridParameters, ModelParameters, create_grid, integrate_model
from ..device import DEFAULT
from ..io import _read_csv, _write_csv


def build_model(out_dir="./linear_advection_test"):
    """The example's ModelParameters, its IC file and outputs under
    ``out_dir``."""
    return ModelParameters(
        ts=0.05,
        integration_time=100.0,
        output_interval=50.0,
        equation_set="LinearAdvection1D",
        initial_conditions=os.path.join(out_dir, "1d_linear_advection_test_ics.csv"),
        output_dir=out_dir,
        grid_params=GridParameters(
            geometry="R",
            xmin=-50.0,
            xmax=50.0,
            num_cells=100,
            BCL={"u": BC.PERIODIC},
            BCR={"u": BC.PERIODIC},
            vars={"u": 1},
        ),
        physical_params={"c_0": 1.0, "K": 0.0},
    )


def write_ics(model, sigma=20.0):
    """The Gaussian exp(-(r / sigma)^2) on the grid's points."""
    r = create_grid(model.grid_params, torch.float64, device="cpu").gridpoints()[:, 0]
    os.makedirs(os.path.dirname(model.initial_conditions), exist_ok=True)
    _write_csv(model.initial_conditions, ["r", "u"],
               np.stack([r, np.exp(-((r / sigma) ** 2))], axis=1))


def run(out_dir="./linear_advection_test", dtype=None, device=DEFAULT) -> float:
    """One period through integrate_model on ``device`` (the card unless the
    caller asks for the CPU); returns L2(initial - final) of the outputs."""
    model = build_model(out_dir)
    write_ics(model)
    integrate_model(model, dtype=dtype, device=device)
    _, initial = _read_csv(os.path.join(out_dir, "physical_out_0.0.csv"))
    _, final = _read_csv(os.path.join(out_dir, "physical_out_100.0.csv"))
    return float(np.sqrt(np.sum((initial[:, 1] - final[:, 1]) ** 2)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    ap.add_argument("--dir", default="./linear_advection_test")
    args = ap.parse_args(argv)
    l2 = run(args.dir, dtype=torch.float64 if args.cpu else torch.float32,
             device="cpu" if args.cpu else DEFAULT)
    print(f"L2 norm of (initial - final): {l2:.3e}  (should be small)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
