"""24-hour two-way wavenumber-2 run, the float32 production configuration.

Identical physics to twoway.py (ref models/cha_bell2024/
Twoway_ShallowWater_Slab.jl) plus an outer boundary treatment over the last
45 km: a Sommerfeld radiation strip (carries outgoing gravity waves through
the open edge) combined with a Rayleigh sponge (tau = 600 s, relaxing the
slow remainder to the initial far-field state).  The marginal
extreme-intensification regime harbors an outer-boundary instability
(reflected gravity waves at the open r = 300 km edge feeding a
boundary-layer momentum blow-up) whose onset depends on the trajectory's
noise level; in float32 it sets in at t ~ 8-9 h without this treatment.
The sponge removes the energy source and the strip the reflection; the
storm core (RMW ~ 30-50 km) is more than 200 km from the strip.
"""

from scythe_tpu_torch import ModelParameters
from scythe_tpu_torch.models.cha_bell2024.common import GRID, PHYSICS

model = ModelParameters(
    ts=3.0,
    integration_time=86400.0,
    output_interval=120.0,
    equation_set="Twoway_ShallowWater_Slab",
    initial_conditions="./Twoway_SWslab_wave2/SWslab_wave2.csv",
    output_dir="./Twoway_SWslab_wave2_tpu/",
    grid_params=GRID,
    physical_params={**PHYSICS, "S1": 1.0e-5},
    options={
        "radiation_width": 45000.0,
        "sponge_width": 45000.0,
        "sponge_tau": 600.0,
    },
)
