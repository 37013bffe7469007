"""Smagorinsky-type nonlinear eddy viscosity, in PyTorch.

The counterpart of ``scythe_tpu.physics.turbulence``: K_t = (Cs Delta)^2 |S|
from the first-derivative slots the transforms already produce, applied as
(K + K_t) * laplacian, and capped at a fraction of the explicit diffusive
stability limit.  The grid spacings are static numpy (float64) built once;
the fields are tensors of any dtype and device.  Enabled with
``options['smagorinsky'] = Cs``.
"""

from __future__ import annotations

import numpy as np
import torch


def ring_arc_spacing(grid):
    """Per-ring azimuthal arc spacing [rDim] (static numpy, cached on the
    grid as ``smag_dy``): 2 pi max(|r|, dx) / nl, capped at 4 dx (the
    anisotropy cap of the JAX package: on near-axisymmetric runs the ring
    arc is a coordinate artifact, not a filter scale).  On SL/SLZ grids r and
    dx are latitudes, taken to metres (a cos(lat), a dphi); on XYZ the
    uniform y spacing, a scalar.  None on grids without an azimuthal axis."""
    cached = getattr(grid, "smag_dy", "unset")
    if not isinstance(cached, str):
        return cached
    p = grid.params
    if grid._struct not in ("RL", "RLZ"):
        dy = None
    elif grid.geometry == "XYZ":
        dy = (p.ymax - p.ymin) / max(grid.nl, 1)
    else:
        dx = (p.xmax - p.xmin) / max(p.rDim, 1)
        r = np.asarray(grid.r_mish, np.float64)
        if grid.geometry in ("SL", "SLZ"):
            r = p.sphere_radius * np.cos(r)
            dx = p.sphere_radius * dx
        dy = 2.0 * np.pi * np.maximum(np.abs(r), dx) / max(grid.nl, 1)
        dy = np.minimum(dy, 4.0 * dx)
    grid.smag_dy = dy
    return dy


def length_scales(grid):
    """(dx, dy, dz) physical spacings: dx the mean radial mish spacing
    (scalar; metres of latitude on SL/SLZ), dy the per-ring arc spacing
    ([rDim], a scalar on XYZ, or None), dz the local Chebyshev spacing
    ([nz], floored at 1 mm, or None)."""
    p = grid.params
    dx = (p.xmax - p.xmin) / max(p.rDim, 1)
    if grid.geometry in ("SL", "SLZ"):
        dx = p.sphere_radius * dx
    dy = ring_arc_spacing(grid)
    if grid._struct in ("RZ", "RLZ"):
        z = np.asarray(grid.z_mish, np.float64)
        dz = np.empty_like(z)
        dz[:-1] = np.abs(np.diff(z))
        dz[-1] = dz[-2]
        dz = np.maximum(dz, 1e-3)
    else:
        dz = None
    return dx, dy, dz


def _sq(x):
    return x * x if x is not None else 0.0


def _half(a, b):
    if a is None and b is None:
        return None
    s = (a if a is not None else 0.0) + (b if b is not None else 0.0)
    return 0.5 * s


def smagorinsky_viscosity(grid, ts, cs, du, dv, dw, dtype, n2=None,
                          pr=1.0 / 3.0, cap_frac=0.02,
                          split_vertical=False, horizontal_only=False):
    """Capped Smagorinsky viscosity field, as
    ``scythe_tpu.physics.turbulence.smagorinsky_viscosity``.

    ``du``/``dv``/``dw``: the physical derivatives (d/dx, d/dy, d/dz) of each
    velocity component, None where a direction does not exist.  ``n2``: the
    squared buoyancy frequency for the Lilly Richardson factor
    sqrt(max(1 - Ri/Pr, 0)).  ``horizontal_only``: 2-D strain, horizontal
    filter scale and cap, one K_h for the horizontal Laplacian.
    ``split_vertical``: returns (k_h capped at the horizontal limit, k_v
    uncapped) for the implicit vertical diffusion."""
    if split_vertical and horizontal_only:
        raise ValueError("split_vertical and horizontal_only are exclusive")
    dx, dy, dz = length_scales(grid)
    device = du[0].device
    # the static constants go to the device once a grid (``smag_consts``): a
    # copy from the host every step could not be captured in a CUDA graph
    consts = grid.__dict__.setdefault("smag_consts", {})

    def const(name, a):
        key = (name, ts, cap_frac, dtype, str(device))
        if key not in consts:
            consts[key] = torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                          device=device)
        return consts[key]

    s12 = _half(du[1], dv[0] if dv else None)
    if horizontal_only:
        smag2 = 2.0 * (_sq(du[0]) + _sq(dv[1] if dv else None)) + 4.0 * _sq(s12)
        smag = torch.sqrt(smag2)
        dy_h = dy if dy is not None else dx
        if getattr(dy_h, "ndim", 0) >= 1:
            dy_h = dy_h[:, None, None] if dz is not None else dy_h[:, None]
        delta_h = (np.asarray(dx, np.float64) * dy_h) ** 0.5
        inv2_hh = 1.0 / dx**2 + (1.0 / (dy_h * dy_h) if dy is not None else 0.0)
        k_t = (cs * const("delta_h", delta_h)) ** 2 * smag
        return torch.minimum(k_t, const("cap_h", cap_frac / (ts * inv2_hh)))
    s13 = _half(du[2], dw[0] if dw else None)
    s23 = _half(dv[2] if dv else None, dw[1] if dw else None)
    smag2 = 2.0 * (
        _sq(du[0]) + _sq(dv[1] if dv else None) + _sq(dw[2] if dw else None)
    ) + 4.0 * (_sq(s12) + _sq(s13) + _sq(s23))
    if n2 is not None:
        ri = n2 / torch.clamp(smag2, min=1.0e-12)
        smag2 = smag2 * torch.clamp(1.0 - ri / pr, min=0.0)
    smag = torch.sqrt(smag2)

    # filter scale: geometric mean of the available spacings, broadcastable
    # against the z-last spatial layout [r, (l), (z)]
    has_z = dz is not None
    if dy is not None and getattr(dy, "ndim", 0) >= 1:
        dy_b = dy[:, None, None] if has_z else dy[:, None]
    else:
        dy_b = dy
    if has_z:
        dz_b = dz[None, None, :] if dy is not None else dz[None, :]

    ndirs = 1 + (dy is not None) + has_z
    prod = np.asarray(dx, np.float64)
    inv2 = np.asarray(1.0 / dx**2, np.float64)
    if dy is not None:
        prod = prod * dy_b
        inv2 = inv2 + 1.0 / (dy_b * dy_b)
    inv2_h = inv2
    if has_z:
        prod = prod * dz_b
        inv2 = inv2 + 1.0 / dz_b**2
    delta = prod ** (1.0 / ndirs)
    # explicit spectral diffusive limit K ts / Delta^2 < ~0.05 (the JAX
    # package's cap_frac, from its measured near-wall blow-ups)
    k_t = (cs * const("delta", delta)) ** 2 * smag
    if split_vertical:
        return torch.minimum(k_t, const("cap_split", cap_frac / (ts * inv2_h))), k_t
    return torch.minimum(k_t, const("cap", cap_frac / (ts * inv2)))
