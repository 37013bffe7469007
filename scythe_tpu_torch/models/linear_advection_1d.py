"""LinearAdvection1D example config (ref models/LinearAdvection1D.jl)."""

from scythe_tpu_torch import BC, GridParameters, ModelParameters

model = ModelParameters(
    ts=0.05,
    integration_time=100.0,
    output_interval=100.0,
    equation_set="LinearAdvection1D",
    initial_conditions="1d_linear_advection_test_ics.csv",
    output_dir="./linearAdvection1D_out/",
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
