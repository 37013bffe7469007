"""scythe_tpu_torch: the PyTorch / CUDA port of scythe-tpu for NVIDIA Hopper.

A second package beside the JAX reference ``scythe_tpu``, with the same
module names.  It imports torch and never jax.  Ported so far: the R, RL,
RZ and RLZ grids, the XYZ box and the SL / SLZ spheres (dense DFT) with all
21 equation sets (the flagship Cha & Bell two-layer shallow-water / slab
models among them, ``examples/cha_bell_initialization.py``; the convective
shower, ``examples/convective_shower_xyz.py``; the Williamson tests,
``examples/williamson_sphere.py``), the explicit AB3 and the semi-implicit
AI2* steppers, every step and run-loop option (``model.py``), and CSV,
NetCDF, spectral and checkpoint I/O.  The vertical column solve and the
analysis of the RLZ-structured grids are hand-written CUDA kernels
(``ops/csrc``) built with nvcc at first use on the card; the other
transforms are matrix products (``torch.einsum``).  The entry
points run on the card by default (``device="cuda"``) and raise where there
is none; pass ``device="cpu"`` to run on the CPU, as the tests do.
Both kernels are ``torch.autograd.Function``s with backward, jvp and vmap
rules, so the port differentiates (``adjoint.make_simulator``,
``fit_parameters``), batches ensembles (``model.integrate_ensemble``) and
balances initial states (``balance.balance_zonal_state``) on the card.
"""

from .config import BC, ZBC, GridParameters, ModelParameters
from .grids.base import Grid, create_grid

__all__ = [
    "BC",
    "ZBC",
    "GridParameters",
    "ModelParameters",
    "Grid",
    "create_grid",
    "integrate_model",
    "make_simulator",
]


def integrate_model(model, dtype=None, write_outputs=True, resume_from=None,
                    profile_dir=None, device="cuda"):
    """Public driver (ref src/Scythe.jl:37-62); see model.integrate_model."""
    from .model import integrate_model as _run

    return _run(model, dtype=dtype, write_outputs=write_outputs,
                resume_from=resume_from, profile_dir=profile_dir, device=device)


def make_simulator(model, dtype=None, n_steps=None, remat=True, device="cuda"):
    """Differentiable end-to-end simulator (adjoint.make_simulator):
    sim(params, phys0) -> final fields, for torch.autograd and torch.func."""
    from .adjoint import make_simulator as _mk

    return _mk(model, dtype=dtype, n_steps=n_steps, remat=remat, device=device)
