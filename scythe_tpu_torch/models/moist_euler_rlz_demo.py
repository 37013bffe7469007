"""Demo config: full 3-D cylindrical moist core (MoistEulerRLZ).

Needs a sounding file and ICs under ./moist_rlz/ (the paths below, relative
to the working directory); 16 cells x 32 azimuths x 40 levels, ts 0.25 s,
600 s = 2,400 semi-implicit steps.
"""

from scythe_tpu_torch import BC, GridParameters, ModelParameters

model = ModelParameters(
    ts=0.25,
    integration_time=600.0,
    output_interval=60.0,
    equation_set="MoistEulerRLZ",
    initial_conditions="./moist_rlz/ics.csv",
    output_dir="./moist_rlz/",
    ref_state_file="./moist_rlz/sounding.txt",
    grid_params=GridParameters(
        geometry="RLZ",
        xmin=0.0,
        xmax=20000.0,
        num_cells=16,
        lDim=32,
        zmin=0.0,
        zmax=10000.0,
        zDim=40,
        BCL={"u": BC.R1T0, "v": BC.R1T0, "w": BC.R1T1},
        BCR={"u": BC.R1T0, "v": BC.R0},
        vars={
            "s": 1, "xi": 2, "mu": 3, "u": 4, "v": 5, "w": 6,
            "mu_c": 7, "mu_r": 8, "qss": 9,
        },
    ),
    physical_params={"K": 10.0, "f": 5.0e-5},
    options={"semiimplicit": True},
)
