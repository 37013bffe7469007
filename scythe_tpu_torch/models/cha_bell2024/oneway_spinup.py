"""3-hour symmetric spinup of the one-way model
(ref models/cha_bell2024/Oneway_ShallowWater_Slab_spinup.jl)."""

from scythe_tpu_torch import ModelParameters
from scythe_tpu_torch.models.cha_bell2024.common import GRID, PHYSICS

model = ModelParameters(
    ts=3.0,
    integration_time=10800.0,
    output_interval=3600.0,
    equation_set="Oneway_ShallowWater_Slab",
    initial_conditions="./Oneway_SWslab_spinup/SWslab_OnewayRankine.csv",
    output_dir="./Oneway_SWslab_spinup/",
    grid_params=GRID,
    physical_params={**PHYSICS, "K": 3000.0},
)
