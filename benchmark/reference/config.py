"""Frozen copy of ``scythe_tpu_torch/config.py`` for the benchmark's plain
reference (imports rewritten; it imports nothing of the port).

Run configuration: GridParameters and ModelParameters.

The same frozen dataclasses as ``scythe_tpu.config`` (the reference's
config surface, src/Scythe.jl:8-21 and src/spectralGrid.jl:20-45), so a
configuration reads alike in both packages, the grid switches
``l_factored`` (the radix-split azimuthal DFT) and ``deriv_single``
(single-pass bf16 derivative synthesis in compensated mode) included, each
with the JAX meaning: None is auto (grids/base.py create_grid).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Mapping


from .bspline import BC, MUBAR
from .chebyshev import ZBC, b_zdim

__all__ = ["BC", "ZBC", "GridParameters", "ModelParameters"]


def _normalize_bc(bc, varnames, default):
    """Accept a single BC, a {var: BC} mapping, or an already-normalized
    tuple (so dataclasses.replace re-runs __post_init__ cleanly); return a
    tuple aligned with the ordered variable list (hashable for
    jit-static use)."""
    if bc is None:
        return tuple(default for _ in varnames)
    if isinstance(bc, (BC, ZBC)):
        return tuple(bc for _ in varnames)
    if isinstance(bc, (tuple, list)):
        if len(bc) != len(varnames):
            raise ValueError(f"BC tuple length {len(bc)} != {len(varnames)} vars")
        return tuple(bc)
    return tuple(bc.get(name, default) for name in varnames)


def _normalize_vars(vars_map) -> tuple[str, ...]:
    """{name: 1-based index} (reference convention) -> ordered name tuple."""
    if isinstance(vars_map, (tuple, list)):
        return tuple(vars_map)
    items = sorted(vars_map.items(), key=lambda kv: kv[1])
    idx = [i for _, i in items]
    if idx != list(range(1, len(idx) + 1)):
        raise ValueError(f"vars indices must be 1..n, got {vars_map}")
    return tuple(name for name, _ in items)


def _moist_production(geometry: str) -> dict:
    """The vetted long-run moist option bundle (docs/RESULTS.md "the
    stable pair" + the stiff-column fixes), so production experiments do
    not have to re-assemble it by hand.  Defaults deliberately reproduce
    reference quirks (PARITY.md); this profile is the measured-stable
    alternative:

    - ``sedimentation='active'``: rain actually falls/exits (the
      reference's always-zero quirk pumps the stratosphere);
    - ``stiff_relaxation='exp'``: exact exponential integration of the
      qss relaxation (invtau ~ 1/p crosses the AB3 limit in deep cold
      columns);
    - ``si_mode='variable'``: variable-coefficient implicit vertical
      operator (exactly reduces to the reference matrix for constant
      profiles);
    - ``condensation='diagnostic'``: rate-capped saturation adjustment
      (an uncapped adjustment detonates in one output interval on a
      spectral basis — measured, tools/shower_envelope.py);
    - modal filter tau=30 s with geometry-dependent axes: the full-axes
      filter is the measured XYZ stable-pair partner, but a RADIAL
      factor on a balanced cylindrical/spherical vortex damps the
      warm-core pressure field and drives spurious inflow at coarse
      cells (tools/probe_tc_blowup.py) — RLZ/SLZ filter the azimuthal
      axis only.

    Any explicitly passed option overrides its profile value.
    """
    prof = {
        "semiimplicit": True,
        "sedimentation": "active",
        "stiff_relaxation": "exp",
        "si_mode": "variable",
        "condensation": "diagnostic",
        "modal_filter_tau": 30.0,
        "modal_filter_axes": "l" if geometry in ("RLZ", "SLZ") else "rlz",
    }
    return prof


_PROFILES = {"moist_production": _moist_production}


@dataclass(frozen=True)
class GridParameters:
    """Static grid configuration (ref src/spectralGrid.jl:20-45).

    ``vars`` may be given as the reference-style {name: 1-based index} dict
    or an ordered tuple of names.  BC arguments accept a single family or a
    {var: family} mapping.
    """

    geometry: str = "R"
    xmin: float = 0.0
    xmax: float = 1.0
    num_cells: int = 1
    l_q: float = 2.0
    BCL: Any = None
    BCR: Any = None
    lDim: int = 0  # uniform azimuthal points (0 = auto); XYZ: y points
    # Cartesian XYZ box only (beyond the reference's four geometries):
    # periodic y extent; lDim sets the y point count.
    ymin: float = 0.0
    ymax: float = 0.0
    # Spherical shell ("SL") only: planet radius [m].  For SL grids,
    # xmin/xmax are the latitude bounds in RADIANS (mish points never
    # reach the exact poles) and lDim is the longitude point count.
    sphere_radius: float = 6.371e6
    l_factored: Any = None  # radix-split azimuthal DFT (None = auto: nl>2048)
    deriv_single: Any = None  # single-pass bf16 derivative synthesis
    # (None = auto; only active in compensated mode, see grids/base.py)
    zmin: float = 0.0
    zmax: float = 0.0
    zDim: int = 0
    BCB: Any = None
    BCT: Any = None
    vars: Any = ("u",)

    def __post_init__(self):
        names = _normalize_vars(self.vars)
        object.__setattr__(self, "vars", names)
        object.__setattr__(self, "BCL", _normalize_bc(self.BCL, names, BC.R0))
        object.__setattr__(self, "BCR", _normalize_bc(self.BCR, names, BC.R0))
        object.__setattr__(self, "BCB", _normalize_bc(self.BCB, names, ZBC.R0))
        object.__setattr__(self, "BCT", _normalize_bc(self.BCT, names, ZBC.R0))

    # Derived dimensions (ref spectralGrid.jl:25-36)
    @property
    def rDim(self) -> int:
        return self.num_cells * MUBAR

    @property
    def b_rDim(self) -> int:
        return self.num_cells + 3

    @property
    def b_zDim(self) -> int:
        return b_zdim(self.zDim) if self.zDim else 0

    @property
    def nvars(self) -> int:
        return len(self.vars)

    def var_index(self, name: str) -> int:
        return self.vars.index(name)


def _freeze(d: Mapping | None) -> tuple:
    if not d:
        return ()
    return tuple(sorted((str(k).lstrip(":"), v) for k, v in d.items()))


@dataclass(frozen=True)
class ModelParameters:
    """Top-level run configuration (ref src/Scythe.jl:8-21)."""

    ts: float = 0.0
    integration_time: float = 1.0
    output_interval: float = 1.0
    equation_set: str = "LinearAdvection1D"
    initial_conditions: str = "ic.csv"
    output_dir: str = "./output/"
    ref_state_file: str = ""
    grid_params: GridParameters = field(default_factory=GridParameters)
    physical_params: Any = ()
    options: Any = ()

    def __post_init__(self):
        if isinstance(self.physical_params, Mapping):
            object.__setattr__(self, "physical_params", _freeze(self.physical_params))
        if isinstance(self.options, Mapping):
            object.__setattr__(self, "options", _freeze(self.options))

    def phys(self) -> dict:
        return dict(self.physical_params)

    def opts(self) -> dict:
        base = {"semiimplicit": False, "exact_reference_state": False}
        user = dict(self.options)
        profile = user.pop("profile", None)
        if profile is not None:
            if profile not in _PROFILES:
                raise ValueError(
                    f"unknown options profile {profile!r}; known: "
                    f"{sorted(_PROFILES)}"
                )
            base.update(_PROFILES[profile](self.grid_params.geometry))
        base.update(user)  # explicit user options win over the profile
        return base

    @property
    def num_ts(self) -> int:
        return int(round(self.integration_time / self.ts))

    @property
    def output_int(self) -> int:
        return int(round(self.output_interval / self.ts))

    def with_(self, **kw) -> "ModelParameters":
        return replace(self, **kw)
