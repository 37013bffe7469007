"""Gradient-based calibration of the slab boundary layer's drag
coefficient through the whole dynamical core, in PyTorch: the port of
``examples/calibrate_drag.py``.

Spin a 30 m/s vortex over the Williams (2013) slab TCBL for one simulated
hour with the true Cd = 2.4e-3, keep the final (u, v) winds as
observations, then start from Cd = 1.0e-3 and let Adam (log space) on the
adjoint of the 720-step integration pull it back
(``scythe_tpu_torch.adjoint``).

    python -m scythe_tpu_torch.examples.calibrate_drag [--cpu] [--steps 80]

On the card the run is float32, on the CPU float64.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

CD_TRUE = 2.4e-3
CD_INIT = 1.0e-3


def drag_model(num_cells=100, xmax=4.0e5, t_end=3600.0, out_dir="./calibrate_out/"):
    """The example's Williams2013_slabTCBL configuration (tests/test_adjoint.py
    takes it at 20 cells over 200 km for 300 s)."""
    from .. import BC, GridParameters, ModelParameters

    gp = GridParameters(
        geometry="R", xmin=0.0, xmax=xmax, num_cells=num_cells,
        BCL={"vgr": BC.R1T0, "u": BC.R1T0, "v": BC.R1T0, "w": BC.R1T1},
        BCR={"vgr": BC.R0, "u": BC.R1T1, "v": BC.R0, "w": BC.R0},
        vars={"vgr": 1, "u": 2, "v": 3, "w": 4},
    )
    return ModelParameters(
        ts=5.0, integration_time=t_end, output_interval=t_end,
        equation_set="Williams2013_slabTCBL", initial_conditions="unused.csv",
        output_dir=out_dir, grid_params=gp,
        physical_params={"K": 1500.0, "Cd": CD_TRUE, "h": 1000.0, "f": 5.0e-5},
    )


def rankine_phys(grid):
    """The 30 m/s Rankine gradient wind (rm 50 km) as vgr and v; u = w = 0."""
    r = grid.gridpoints()[:, 0]
    rm, vm = 5.0e4, 30.0
    vgr = np.where(r < rm, vm * r / rm, vm * rm / r)
    return np.stack([vgr, np.zeros_like(r), vgr, np.zeros_like(r)])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--steps", type=int, default=80, help="Adam iterations")
    args = ap.parse_args(argv)
    from ..adjoint import fit_parameters, make_simulator

    device = "cpu" if args.cpu else "cuda"
    dtype = torch.float64 if args.cpu else torch.float32
    sim, grid, _ = make_simulator(drag_model(), dtype, device=device)
    phys0 = rankine_phys(grid)
    print(f"generating observations with true Cd = {CD_TRUE:.4e} ...")
    t0 = time.time()
    with torch.no_grad():
        obs = sim({"Cd": CD_TRUE}, phys0)[1:3]
    print(f"  {grid.params.num_cells}-cell, 720-step forward run: {time.time() - t0:.2f}s; "
          f"peak inflow {float(obs[0].min()):.2f} m/s, peak v {float(obs[1].max()):.2f} m/s")
    print(f"calibrating from Cd = {CD_INIT:.4e} ({args.steps} Adam steps, log-space) ...")
    t0 = time.time()
    fitted, history = fit_parameters(sim, {"Cd": CD_INIT}, phys0, obs, steps=args.steps,
                                     learning_rate=0.08, obs_slice=np.s_[1:3])
    dt = time.time() - t0
    for i in range(0, len(history), max(1, len(history) // 10)):
        print(f"  iter {i:3d}  normalized misfit = {history[i]:.3e}")
    err = abs(fitted["Cd"] - CD_TRUE) / CD_TRUE
    print(f"recovered Cd = {fitted['Cd']:.4e} (true {CD_TRUE:.4e}, error {100 * err:.2f}%) "
          f"in {dt:.1f}s ({dt / args.steps:.2f}s per value+grad)")
    print("SUCCESS: drag coefficient recovered to <5%" if err < 0.05
          else "WARNING: calibration did not converge to 5%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
