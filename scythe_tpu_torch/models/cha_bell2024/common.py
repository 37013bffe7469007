"""Shared grid configuration for the Cha & Bell (2024) two-layer models
(ref models/cha_bell2024/*.jl)."""

from scythe_tpu_torch import BC, GridParameters

GRID = GridParameters(
    geometry="RL",
    xmin=0.0,
    xmax=3.0e5,
    num_cells=100,
    lDim=256,  # uniform azimuthal points (reference uses ragged rings)
    BCL={
        "h": BC.R1T1,
        "u": BC.R1T0,
        "v": BC.R1T0,
        "ub": BC.R1T0,
        "vb": BC.R1T0,
        "wb": BC.R1T1,
    },
    BCR={
        "h": BC.R0,
        "u": BC.R1T1,
        "v": BC.R0,
        "ub": BC.R1T1,
        "vb": BC.R0,
        "wb": BC.R0,
    },
    vars={"h": 1, "u": 2, "v": 3, "ub": 4, "vb": 5, "wb": 6},
)

PHYSICS = {
    "g": 9.81,
    "K": 5000.0,
    "Cd": 2.4e-3,
    "Hfree": 2000.0,
    "Hb": 1000.0,
    "f": 5.0e-5,
}
