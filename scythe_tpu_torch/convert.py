"""State carried across between the JAX package and the port.

The dynamical core has no learned weights: what a run carries is the grid
operators (rebuilt from the configuration by either package), the reference
state, the model state and the context extras its options read (the
sponges' and the radiation boundary's reference fields).  These functions
move the last three across as numpy arrays, so a run can start in one package from the other's state.
A state carries as it is laid out on its grid: the K_f slots of a
factored-DFT grid, float32 from a compensated one (tests/test_torch_
{factored_dft,compensated}.py step each once against the JAX package).
Nothing here imports jax: a JAX array converts through ``np.asarray``.
Every loader puts its tensors on the card unless the caller asks for the
CPU (``device="cpu"``).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .device import DEFAULT, resolve_device
from .physics.reference_state import ReferenceState
from .timeintegration import ModelState

_STATE_ARRAYS = ("spec", "expdot_nm1", "expdot_nm2", "impdot_nm1", "impdot_nm2")
# ctx.extras a ported option reads (model._set_boundary_refs and
# model._set_topography build them)
_CONTEXT_EXTRAS = ("sponge_ref", "radiation_ref_dr", "hs_grad", "hs_filtered")


def _fields(src, names) -> dict:
    if isinstance(src, Mapping) or hasattr(src, "files"):  # dict or NpzFile
        return {k: src[k] for k in names}
    return {k: getattr(src, k) for k in names}


def state_from_numpy(d, device: Any = DEFAULT, dtype=None) -> ModelState:
    """A ``ModelState`` from the JAX package's fields (a mapping, an
    ``.npz`` file or a ``scythe_tpu.timeintegration.ModelState``): the five
    arrays go to ``device`` (the card unless the caller asks for the CPU;
    as ``dtype``, or their own dtype when None), ``t`` becomes a Python
    int."""
    device = resolve_device(device)
    f = _fields(d, _STATE_ARRAYS + ("t",))

    def dev(a):
        t = torch.from_numpy(np.array(a))
        return t.to(device=device, dtype=dtype or t.dtype)

    return ModelState(
        **{k: dev(f[k]) for k in _STATE_ARRAYS}, t=int(np.asarray(f["t"]))
    )


def state_to_numpy(state: ModelState) -> dict[str, np.ndarray]:
    """The fields of ``state`` as host numpy arrays, ``t`` as an int32
    scalar, the layout ``scythe_tpu.io.save_checkpoint`` writes."""
    out = {k: getattr(state, k).detach().cpu().numpy() for k in _STATE_ARRAYS}
    out["t"] = np.asarray(state.t, np.int32)
    return out


def load_jax_checkpoint(path: str, device: Any = DEFAULT, dtype=None):
    """Read the ``.npz`` written by ``scythe_tpu.io.save_checkpoint``;
    returns (ModelState, t_sim)."""
    from .io import load_checkpoint

    return load_checkpoint(path, dtype, device)


def context_extras_from_numpy(extras, device: Any = DEFAULT, dtype=None) -> dict:
    """The context extras a run carries besides its state, from the JAX
    package's ``ctx.extras`` (a mapping of arrays): ``sponge_ref``, the
    filtered initial state the sponges relax toward, ``radiation_ref_dr``,
    its radial derivative, which the radiation boundary reads, and
    ``hs_grad`` and ``hs_filtered``, the filtered topography gradient and
    height (options['topography_file']).  Merge the
    result into the port's ``ctx.extras`` to continue a run begun in the
    JAX package."""
    device = resolve_device(device)
    out = {}
    for k in _CONTEXT_EXTRAS:
        if k in extras:
            t = torch.from_numpy(np.array(extras[k]))
            out[k] = t.to(device=device, dtype=dtype or t.dtype)
    return out


def reference_state_from_numpy(rs, device: Any = DEFAULT, dtype=torch.float64) -> ReferenceState:
    """A port ``ReferenceState`` from the JAX package's (any object or
    mapping with the six fields)."""
    device = resolve_device(device)
    f = _fields(rs, ReferenceState._fields)
    return ReferenceState(
        **{
            k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
            for k, v in f.items()
        }
    )
