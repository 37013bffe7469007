"""24-hour two-way (mass sink/source feedback) wavenumber-2 run
(ref models/cha_bell2024/Twoway_ShallowWater_Slab.jl)."""

from scythe_tpu_torch import ModelParameters
from scythe_tpu_torch.models.cha_bell2024.common import GRID, PHYSICS

model = ModelParameters(
    ts=3.0,
    integration_time=86400.0,
    output_interval=120.0,
    equation_set="Twoway_ShallowWater_Slab",
    initial_conditions="./Twoway_SWslab_wave2/SWslab_wave2.csv",
    output_dir="./Twoway_SWslab_wave2/",
    grid_params=GRID,
    physical_params={**PHYSICS, "S1": 1.0e-5},
)
