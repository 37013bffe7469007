"""The mature-TC production configuration (round-4 "sweep 10") as a named
model: the settings that carried a 3-D moist-core tropical cyclone through
150 h of intensification to a mature vortex (the JAX package's
``models/tc_mature_rlz.py``).  The option bundle: diagnostic condensation
capped at 2e-4 kg/kg/s with condensation_tau 30 s, (r,z)-plane Smagorinsky
Cs 0.2 with implicit vertical diffusion, active sedimentation, exp stiff
relaxation, surface fluxes and the outer sponge.  The initial conditions
(a 15 m/s gradient-balanced vortex and an 85%-saturated moist core 10 km
deep) come from scythe_tpu_torch/examples/tc_intensification_rlz.py and
are written, on the CPU, where the file is missing.
"""

import os

import torch

from scythe_tpu_torch import create_grid
from scythe_tpu_torch.examples.tc_intensification_rlz import build_model, write_ics
from scythe_tpu_torch.model import build_context

_OUT = "./tc_mature/"

model = build_model(
    _OUT,
    num_cells=100,
    ts=2.0,
    t_end=150 * 3600.0,
    fluxes=True,
    stable=True,
    cap=2.0e-4,
    rh=0.9,
    qv0=20.0,
    smag=0.20,
    ivd=True,
    cond_tau=30.0,
)

if not os.path.exists(model.initial_conditions):
    _grid = create_grid(model.grid_params, torch.float64, device="cpu")
    _ctx = build_context(model, _grid, torch.float64)
    write_ics(model, _grid, _ctx.ref_state, vmax=15.0, moist_core=0.85,
              moist_core_depth=10000.0)
