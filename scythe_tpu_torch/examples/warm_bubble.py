"""Moist warm-bubble demo (BF02-style) on the RZ grid with the
semi-implicit acoustic solve, in PyTorch: the port of
``examples/warm_bubble.py``.

Builds a sounding and a 3 K-amplitude entropy bubble, runs 5 minutes of
model time (BF02_test, 25 cells x 40 levels, ts 0.1 s: 3,000 steps, one
column solve of 75 x 40 columns a step), and reports the bubble's rise.

Run:  python -m scythe_tpu_torch.examples.warm_bubble [--cpu] [--dir DIR]
(float32 on the card, float64 with --cpu.)
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import BC, GridParameters, ModelParameters, create_grid, integrate_model
from ..device import DEFAULT
from ..io import _write_csv


def build_model(out_dir="./warm_bubble_out", t_end=300.0):
    """The example's ModelParameters, its sounding written under
    ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    zs = np.linspace(0.0, 12000.0, 50)
    theta = 300.0 + 0.004 * zs
    qv = 14.0 * np.exp(-zs / 2500.0)
    sounding = os.path.join(out_dir, "sounding.txt")
    with open(sounding, "w") as f:
        f.write(f"1015.0 {theta[0]} {qv[0]}\n")
        for z, th, q in zip(zs[1:], theta[1:], qv[1:]):
            f.write(f"{z} {th} {q}\n")
    gp = GridParameters(
        geometry="RZ",
        xmin=0.0,
        xmax=10000.0,
        num_cells=25,
        zmin=0.0,
        zmax=10000.0,
        zDim=40,
        BCL={"u": BC.R1T0, "w": BC.R1T1},
        BCR={"u": BC.R1T0},
        vars={"s": 1, "xi": 2, "mu": 3, "u": 4, "w": 5, "mu_l": 6, "qss": 7},
    )
    return ModelParameters(
        ts=0.1,
        integration_time=t_end,
        output_interval=60.0,
        equation_set="BF02_test",
        initial_conditions=os.path.join(out_dir, "ics.csv"),
        output_dir=out_dir,
        ref_state_file=sounding,
        grid_params=gp,
        physical_params={"K": 5.0},
        options={"semiimplicit": True},
    )


def write_ics(model):
    """The cos^2 entropy bubble (3 in s, radius 2 km, centred 2 km up on the
    axis); every other variable zero."""
    gp = model.grid_params
    pts = create_grid(gp, torch.float64, device="cpu").gridpoints()
    r, z = pts[:, 0], pts[:, 1]
    rad = np.sqrt((r / 2000.0) ** 2 + ((z - 2000.0) / 2000.0) ** 2)
    cols = np.zeros((len(r), 2 + len(gp.vars)))
    cols[:, :2] = pts
    cols[:, 2 + gp.var_index("s")] = (
        3.0 * np.maximum(0.0, np.cos(np.pi * np.minimum(rad, 1.0) / 2.0)) ** 2)
    _write_csv(model.initial_conditions, ["r", "z", *gp.vars], cols)


def readings(grid, phys):
    """(w_max m/s, the entropy bubble's centroid height m) of final fields
    [nvars, *spatial] (numpy)."""
    gp = grid.params
    w = phys[gp.var_index("w")]
    s = phys[gp.var_index("s")].reshape(grid.spatial_shape)
    return float(w.max()), float((s * grid.z_mish[None, :]).sum() / s.sum())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    ap.add_argument("--dir", default="./warm_bubble_out")
    args = ap.parse_args(argv)
    model = build_model(args.dir)
    write_ics(model)
    grid, phys = integrate_model(model, dtype=torch.float64 if args.cpu else torch.float32,
                                 device="cpu" if args.cpu else DEFAULT)
    w_max, zc = readings(grid, phys)
    print(f"after 300 s: w_max = {w_max:.2f} m/s, bubble centroid z = {zc:.0f} m "
          "(started 2000 m)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
