"""scythe_tpu_torch: the PyTorch / CUDA port of scythe-tpu for NVIDIA Hopper.

A second package beside the JAX reference ``scythe_tpu``, with the same
module names.  It imports torch and never jax.  Ported so far: the moist
3-D semi-implicit core on RLZ grids (``MoistEulerRLZ`` with the AI2*
corrector) and the mature-TC option bundle; its vertical column solve and
RLZ analysis are hand-written CUDA kernels (``ops/csrc``) built with nvcc
at first use on the card.  The entry points run on the card by default
(``device="cuda"``) and raise where there is none; pass ``device="cpu"``
to run on the CPU, as the tests do.
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
]


def integrate_model(model, dtype=None, write_outputs=True, resume_from=None,
                    device="cuda"):
    """Public driver (ref src/Scythe.jl:37-62); see model.integrate_model."""
    from .model import integrate_model as _run

    return _run(model, dtype=dtype, write_outputs=write_outputs,
                resume_from=resume_from, device=device)
