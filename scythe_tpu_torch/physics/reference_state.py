"""Hydrostatic base-state construction from soundings
(ref src/reference_state.jl), in PyTorch.

Built once on the host in float64: the thermodynamic functions run on CPU
float64 tensors made with ``torch.from_numpy``, then every profile moves to
the run's device and dtype in one copy.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..basis import chebyshev
from . import thermodynamics as td


class ReferenceState(NamedTuple):
    """Each profile is [zDim, 3] = (value, d/dz, d2/dz2)
    (ref reference_state.jl:4-10); ``Pxi_bar`` is a 0-d tensor and
    ``Pxi_prof`` its [zDim] per-level profile."""

    sbar: torch.Tensor
    xibar: torch.Tensor
    mubar: torch.Tensor
    mu_lbar: torch.Tensor
    Pxi_bar: torch.Tensor
    Pxi_prof: torch.Tensor


def empty_reference_state(nz: int = 1, dtype=torch.float32, *, device: Any) -> ReferenceState:
    z = torch.zeros((nz, 3), dtype=dtype, device=device)
    return ReferenceState(
        z, z, z, z,
        torch.zeros((), dtype=dtype, device=device),
        torch.zeros((nz,), dtype=dtype, device=device),
    )


def _transform_profile(vals: np.ndarray, zops: chebyshev.ChebyshevOps) -> np.ndarray:
    """Smoothed value + dz + dzz via the truncated Chebyshev fit
    (ref transform_reference_state!, reference_state.jl:138-157)."""
    a = zops.constrain @ (zops.analysis @ vals)
    return np.stack([zops.synth @ a, zops.dsynth @ a, zops.d2synth @ a], axis=1)


def _parse_sounding(path: str):
    """Sounding text file: first line 'p_sfc theta_sfc qv_sfc', then lines
    'z theta qv' (qv in g/kg) (ref reference_state.jl:17-45)."""
    with open(path) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    sfc = lines[0]
    alt = [0.0]
    theta = [float(sfc[1])]
    q_v = [float(sfc[2])]
    for parts in lines[1:]:
        alt.append(float(parts[0]))
        theta.append(float(parts[1]))
        q_v.append(float(parts[2]))
    return float(sfc[0]), np.array(alt), np.array(theta), np.array(q_v)


def _pxi_profile(sbar, xibar, mubar) -> np.ndarray:
    """Per-level squared sound-speed factor Pxi/(rho (1+q)) of the reference
    column; its mean is the reference's scalar Pxi_bar
    (reference_state.jl:127-133)."""
    pxi = td.on_host(td.P_xi_from_s, sbar[:, 0], xibar[:, 0], mubar[:, 0])
    rho_bar = td.on_host(td.dry_density, xibar[:, 0])
    q_bar = td.on_host(td.ahyp, mubar[:, 0])
    return pxi / (rho_bar * (1.0 + q_bar))


def _finish(sbar, xibar, mubar, mu_lbar, dtype, device) -> ReferenceState:
    pxi_prof = _pxi_profile(sbar, xibar, mubar)

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return ReferenceState(
        dev(sbar), dev(xibar), dev(mubar), dev(mu_lbar),
        dev(float(pxi_prof.mean())), dev(pxi_prof),
    )


def interpolate_reference_file(
    path: str, zmin: float, zmax: float, nz: int, bdim: int,
    dtype=torch.float64, *, device: Any,
) -> ReferenceState:
    """(ref interpolate_reference_file, reference_state.jl:17-136)."""
    sfc_pressure, alt, theta_in, qv_in = _parse_sounding(path)
    zops = chebyshev.build_ops(nz, zmin, zmax, bdim)
    z = zops.points

    theta = np.interp(z, alt, theta_in)
    q_v = np.interp(z, alt, qv_in) * 1.0e-3
    theta[0] = theta_in[0]
    q_v[0] = qv_in[0] * 1.0e-3

    # forward hydrostatic log-p integration (reference_state.jl:74-94)
    Tk = np.zeros(nz)
    p = np.zeros(nz)
    rho_d = np.zeros(nz)
    rho_t = np.zeros(nz)
    p[0] = sfc_pressure
    e = float(td.vapor_pressure(p[0], q_v[0]))
    Tk[0] = theta[0] / (td.p_0 / p[0]) ** (td.Rd / td.Cpd)
    rho_d[0] = 100.0 * (p[0] - e) / (Tk[0] * td.Rd)
    rho_t[0] = rho_d[0] * (1.0 + q_v[0])
    dlnpdz = -td.GRAVITY * rho_t[0] / (p[0] * 100.0)
    for i in range(1, nz):
        p[i] = np.exp(np.log(p[i - 1]) + dlnpdz * (z[i] - z[i - 1]))
        Tk[i] = theta[i] / (td.p_0 / p[i]) ** (td.Rd / td.Cpd)
        e = float(td.vapor_pressure(p[i], q_v[i]))
        rho_d[i] = 100.0 * (p[i] - e) / (Tk[i] * td.Rd)
        rho_t[i] = rho_d[i] * (1.0 + q_v[i])
        dlnpdz = -td.GRAVITY * rho_t[i] / (p[i] * 100.0)

    # spectral re-integration for consistency (reference_state.jl:96-108)
    a = zops.constrain @ (zops.analysis @ (-td.GRAVITY * rho_t))
    p_new = (zops.isynth @ a + sfc_pressure * 100.0) / 100.0
    Tk = theta / (td.p_0 / p_new) ** (td.Rd / td.Cpd)
    e = np.asarray(td.vapor_pressure(p_new, q_v))
    rho_d = 100.0 * (p_new - e) / (Tk * td.Rd)
    rho_t = rho_d * (1.0 + q_v)

    sbar = _transform_profile(td.on_host(td.entropy, Tk, rho_d, q_v), zops)
    xibar = _transform_profile(td.on_host(td.log_dry_density, rho_d), zops)
    mubar = _transform_profile(td.on_host(td.bhyp, q_v), zops)
    return _finish(sbar, xibar, mubar, np.zeros((nz, 3)), dtype, device)


def exact_reference_state(
    path: str, zmin: float, zmax: float, nz: int, bdim: int,
    dtype=torch.float64, *, device: Any,
) -> ReferenceState:
    """Pre-balanced state file: lines 'z sbar xibar mubar mu_lbar' matching
    the model levels (ref exact_reference_state, reference_state.jl:159-199)."""
    zops = chebyshev.build_ops(nz, zmin, zmax, bdim)
    data = np.loadtxt(path)
    if data.shape[0] != nz:
        raise ValueError("reference state file length != zDim")
    if not np.allclose(data[:, 0], zops.points, rtol=1e-6, atol=1e-6):
        raise ValueError("Model levels do not match reference levels")
    profs = [_transform_profile(data[:, c], zops) for c in (1, 2, 3, 4)]
    return _finish(*profs, dtype, device)


def build_reference_state(model, grid, dtype) -> ReferenceState | None:
    """Dispatch helper used by the driver (ref createModelTile,
    semiimplicit.jl:62-72); the state lands on the grid's device."""
    if not model.ref_state_file:
        return None
    p = model.grid_params
    build = (
        exact_reference_state
        if model.opts().get("exact_reference_state")
        else interpolate_reference_file
    )
    return build(
        model.ref_state_file, p.zmin, p.zmax, p.zDim, p.b_zDim, dtype,
        device=grid.device,
    )
