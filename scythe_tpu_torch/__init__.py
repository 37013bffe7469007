"""scythe_tpu_torch: the PyTorch / CUDA port of scythe-tpu for NVIDIA Hopper.

A second package beside the JAX reference ``scythe_tpu``, with the same
module names.  It imports torch and never jax.  Ported so far: the moist
3-D semi-implicit core on RLZ grids (``MoistEulerRLZ`` with the AI2*
corrector), whose vertical column solve is a hand-written CUDA kernel
(``ops/csrc/column_solve.cu``) built with nvcc at first use on the card.
Every entry point takes an explicit ``device`` (default "cpu").
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


def integrate_model(model, **kw):
    """Public driver (ref src/Scythe.jl:37-62); see model.integrate_model."""
    from .model import integrate_model as _run

    return _run(model, **kw)
