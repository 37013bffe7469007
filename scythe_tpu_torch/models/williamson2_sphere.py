"""Williamson case 2 (steady geostrophic flow) on the SL sphere as an
executable model config for the CLI (``python -m scythe_tpu_torch
scythe_tpu_torch/models/williamson2_sphere.py``), with ICs in the reference
CSV schema.

Generate the ICs first:
    python -c "import scythe_tpu_torch.models.williamson2_sphere as m; m.write_ics()"
"""

import numpy as np

from scythe_tpu_torch import GridParameters, ModelParameters

A_EARTH = 6.37122e6
OMEGA = 7.292e-5
G = 9.80616

model = ModelParameters(
    ts=300.0,
    integration_time=86400.0,
    output_interval=43200.0,
    equation_set="ShallowWaterSphere",
    initial_conditions="williamson2_ics.csv",
    output_dir="./williamson2_out/",
    grid_params=GridParameters(
        geometry="SL",
        xmin=-np.pi / 2,
        xmax=np.pi / 2,
        num_cells=32,
        lDim=96,
        sphere_radius=A_EARTH,
        vars={"h": 1, "u": 2, "v": 3},
    ),
    physical_params={"g": G, "Omega": OMEGA, "K": 0.0},
)


def write_ics(path=None):
    """ICs from the example's w2_fields (one source of the balance
    formula), on the grid's points."""
    import torch

    from scythe_tpu_torch import create_grid
    from scythe_tpu_torch.examples.williamson_sphere import w2_fields
    from scythe_tpu_torch.io import _write_csv

    pts = create_grid(model.grid_params, torch.float64, device="cpu").gridpoints()
    h, u, v = w2_fields(pts[:, 0])
    _write_csv(path or model.initial_conditions, ["lat", "lon", "h", "u", "v"],
               np.concatenate([pts, np.stack([h, u, v], axis=1)], axis=1))
