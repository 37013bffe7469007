"""What the reference's equation sets share, frozen from the port
(``scythe_tpu_torch/equations/common.py``): ``EqContext`` and its option
hooks, ``EqResult`` and the helpers; and ``equation_set``, which finds a set
by its name in ``benchmark/reference/eqsets/<name>.py``.

An equation set's module has ``tendency(fields, ctx) -> EqResult``,
``OPTIONS`` (the model options its tendency reads) and, where the port's
step adjusts the updated fields for it, ``after_update(var_np1, impdot,
ctx)``.  A set with no module is refused.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from . import microphysics as mp
from . import thermodynamics as td


@dataclass
class EqContext:
    """Static per-run context handed to equation sets.  The six option
    hooks below carry the JAX package's docstrings' behaviour one for one
    (scythe_tpu.equations.common.EqContext)."""

    grid: Any
    coords: dict[str, torch.Tensor]
    params: dict[str, float]  # physical_params (ref model.physical_params)
    options: dict[str, Any]
    ts: float
    var_index: Callable[[str], int]
    ref_state: Any = None  # physics.reference_state.ReferenceState or None
    extras: dict = field(default_factory=dict)

    def p(self, key: str, default=None) -> float:
        if default is None:
            return self.params[key]
        return self.params.get(key, default)

    def vertical_pgf(self, coeffs, s_z, xi_z, qv_z, default_exact=True):
        """Perturbation-form vertical pressure gradient dp'/dz.  The exact
        form adds P(local)·bar_z - P(bar)·bar_z, the cross term the
        reference omits (testModels.jl:552).  MoistEuler* sets
        (``default_exact``) use it unless options['reference_quirks'];
        reference-parity sets only with options['exact_vertical_pgf']."""
        Ps, Pxi, Pqv = coeffs
        base = Ps * s_z + Pxi * xi_z + Pqv * qv_z
        if default_exact:
            exact = not self.options.get("reference_quirks")
        else:
            exact = bool(self.options.get("exact_vertical_pgf"))
        if not exact:
            return base
        rs = self.ref_state
        qbar_z, pgf_bar = td.reference_pgf_columns(rs)
        # [nz] columns broadcast over the trailing (z-last) spatial axis
        return base + (
            Ps * rs.sbar[:, 1] + Pxi * rs.xibar[:, 1] + Pqv * qbar_z - pgf_bar
        )

    def stiff_rate(self, rate):
        """Stability limiter for explicit relaxation rates: identity, or with
        options['stiff_relaxation']='exp' the exponential-integrator rate
        (1-exp(-rate*ts))/ts capped at 0.4/ts (AB3 safety)."""
        if self.options.get("stiff_relaxation") != "exp":
            return rate
        return torch.clamp(-torch.expm1(-rate * self.ts), max=0.4) / self.ts

    def pxi_si(self):
        """Coefficient of the semi-implicit acoustic term -Pxi xi_z: the
        reference's column-mean scalar times options['si_scale'], or the
        per-level profile with options['si_mode']='variable'."""
        scale = float(self.options.get("si_scale", 1.0))
        if self.options.get("si_mode", "constant") == "variable":
            return scale * self.ref_state.Pxi_prof
        return scale * self.ref_state.Pxi_bar

    def cap_condensation(self, q_cond):
        """Optional symmetric cap on the prognostic condensation rate
        (options['condensation_rate_cap']); a no-op when unset or under
        diagnostic condensation, which owns the cap."""
        if self.options.get("condensation") == "diagnostic":
            return q_cond
        cap = self.options.get("condensation_rate_cap")
        if cap is None:
            return q_cond
        cap = float(cap)
        return torch.clamp(q_cond, -cap, cap)

    def sedimentation(self, q_r, rho_d, Tk):
        """Rain terminal velocity: the reference's always-zero quirk, or with
        options['sedimentation']='active' the unclamped downward formula."""
        if self.options.get("sedimentation") == "active":
            return mp.sedimentation_active(q_r, rho_d, Tk)
        return mp.sedimentation(q_r, rho_d, Tk)

    def dmudq_source(self, mu, q):
        """q->mu source-term Jacobian: the clamped guard, or the reference's
        raw Jacobian with options['reference_quirks']."""
        if self.options.get("reference_quirks"):
            return td.dmudq(mu, q)
        return td.dmudq_source(mu, q)


@dataclass
class EqResult:
    expdot: torch.Tensor  # [nvars, *spatial]
    impdot: torch.Tensor | None = None
    overrides: dict[int, torch.Tensor] = field(default_factory=dict)
    # vertical eddy viscosity [*spatial] for options['implicit_vdiff']
    k_v: torch.Tensor | None = None


def same_param(a, b) -> bool:
    """Whether two physical parameters are one value, decided on the host:
    the same object, or equal Python numbers.  A traced parameter (a tensor,
    adjoint.make_simulator) is never compared by value, so the test cuts no
    graph and does not wait for the card; the form the caller then takes
    computes the same sum."""
    if a is b:
        return True
    return not torch.is_tensor(a) and not torch.is_tensor(b) and a == b


def stack_tendencies(nvars: int, shape, dtype, terms: dict[int, torch.Tensor]):
    """Assemble [nvars, *spatial] from a non-empty {var_index: tendency}
    mapping; the missing rows are zeros on the terms' device."""
    device = next(iter(terms.values())).device
    rows = [
        terms[v] if v in terms else torch.zeros(shape, dtype=dtype, device=device)
        for v in range(nvars)
    ]
    return torch.stack(rows, dim=0)


def laplacian_mask(dtype, device):
    """[9, 1, 1, 1] mask of the moist Euler sets' diffused variables: all but
    xi and qss.  Made on the device by fills, not copied from the host each
    step (a copy a CUDA graph could not capture)."""
    mask = torch.ones(9, dtype=dtype, device=device)
    mask[1:2].zero_()  # a slice and a fill: ``mask[1] = 0.0`` copies a host scalar
    mask[8:9].zero_()
    return mask[:, None, None, None]


def field_of(value, shape, dtype, device):
    """``value`` (a Python number or a tensor, such as a traced parameter)
    broadcast to ``shape`` on ``device``; a number becomes a fill on the
    device, not a copy from the host."""
    if not torch.is_tensor(value):
        value = torch.full((), float(value), dtype=dtype, device=device)
    return torch.broadcast_to(value.to(dtype=dtype, device=device), shape)


def equation_set(name: str):
    """``benchmark/reference/eqsets/<name>.py``."""
    mod = f"{__package__}.eqsets.{name}"
    try:
        return importlib.import_module(mod)
    except ModuleNotFoundError as e:
        if e.name != mod:
            raise
        raise ValueError(f"the reference has no equation set {name!r}: add "
                         f"benchmark/reference/eqsets/{name}.py") from None
