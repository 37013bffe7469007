"""``options["surface_fluxes"]``: bulk air-sea fluxes of entropy, moisture
and momentum at the lowest level, spread over an exp(-z/depth) profile
(``scythe_tpu_torch/model.py``'s ``build_surface_fluxes``), added to the
tendency before the sponge.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import thermodynamics as td

STAGE = "tendency"
ORDER = 10


def build_surface_fluxes(grid, ctx, cfg: dict, dtype):
    """Bulk air-sea fluxes at the lowest level over an exp(-z/depth) profile."""
    p = grid.params
    vi = p.var_index
    rs = ctx.ref_state
    sst = float(cfg["sst"])
    ck = float(cfg.get("Ck", 1.2e-3))
    cd = float(cfg.get("Cd", 1.5e-3))
    depth = float(cfg.get("depth", 600.0))
    floor = float(cfg.get("wind_floor", 1.0))
    z = np.asarray(grid.z_mish, np.float64)
    wz = np.exp(-(z - z[0]) / depth)
    trapz = getattr(np, "trapezoid", None) or np.trapz
    wz = torch.as_tensor(wz / trapz(wz, z), dtype=dtype, device=grid.device)

    def host(x):
        return torch.tensor(float(x), dtype=torch.float64)

    sbar0, xibar0, mubar0 = (float(a[0, 0]) for a in (rs.sbar, rs.xibar, rs.mubar))
    _, rho0, _, p0 = td.thermodynamic_tuple(host(sbar0), host(xibar0), host(mubar0))
    q_star = float(td.q_sat_liquid(host(sst), p0))
    s_star = float(td.entropy(host(sst), rho0, host(q_star)))
    i_s, i_mu, i_u, i_v = vi("s"), vi("mu"), vi("u"), vi("v")

    def apply(expdot, phys, fields):
        u1 = phys[i_u][..., 0]
        v1 = phys[i_v][..., 0]
        spd = torch.sqrt(u1 * u1 + floor * floor + v1 * v1)
        s1 = phys[i_s][..., 0] + sbar0
        mu1 = phys[i_mu][..., 0] + mubar0
        q1 = td.ahyp(mu1)
        f_s = ck * spd * (s_star - s1)
        f_mu = ck * spd * (q_star - q1) * td.dmudq(mu1, q1)
        expdot[i_s] += f_s[..., None] * wz
        expdot[i_mu] += f_mu[..., None] * wz
        expdot[i_u] += (-cd * spd * u1)[..., None] * wz
        expdot[i_v] += (-cd * spd * v1)[..., None] * wz
        return expdot

    return apply


def build(model, grid, ctx, dtype):
    return build_surface_fluxes(grid, ctx, dict(ctx.options["surface_fluxes"]), dtype)
