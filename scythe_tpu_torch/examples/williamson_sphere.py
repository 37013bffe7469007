"""Williamson et al. (1992) global shallow-water tests on the SL sphere, in
PyTorch: the port of ``examples/williamson_sphere.py`` and of the
configuration of ``models/williamson2_sphere.py``.

* Case 1: solid-body advection of a cosine bell (AdvectionSphere), at
  alpha = pi/2 straight over both poles.
* Case 2: steady geostrophic zonal flow; any spurious tendency shows as
  error growth.
* Case 5: zonal flow over a conical mountain, the topography entering as a
  free-surface PGF through ctx.extras['hs_grad'].
* Case 6: the Rossby-Haurwitz wavenumber-4 wave, which moves east at the
  analytic phase speed.

The functions keep the JAX example's names and arguments.  The timestep
rule is the JAX example's: the pole rings keep zonal wavenumber 1, so the
pole-ring gravity-wave CFL binds (case 2 is stable at 300 s, case 6 needs
150 s at 32 cells).  ``williamson2_model(out_dir)`` is the CLI configuration
of ``models/williamson2_sphere.py`` (32 cells x 96, ts 300 s, one day) with
its IC CSV written:

    import torch, scythe_tpu_torch as tx
    from scythe_tpu_torch.examples import williamson_sphere as wm
    grid, phys = tx.integrate_model(wm.williamson2_model("w2_out"),
                                    dtype=torch.float64, device="cuda")
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import GridParameters, ModelParameters, create_grid
from ..device import DEFAULT

A_EARTH = 6.37122e6
OMEGA = 7.292e-5
G = 9.80616


def build_model(num_cells=32, nl=96, ts=180.0, t_end=86400.0):
    gp = GridParameters(
        geometry="SL",
        xmin=-np.pi / 2,
        xmax=np.pi / 2,
        num_cells=num_cells,
        lDim=nl,
        sphere_radius=A_EARTH,
        vars={"h": 1, "u": 2, "v": 3},
    )
    return ModelParameters(
        ts=ts,
        integration_time=t_end,
        output_interval=t_end,
        equation_set="ShallowWaterSphere",
        initial_conditions="unused",
        output_dir="./williamson_out",
        grid_params=gp,
        physical_params={"g": G, "Omega": OMEGA, "K": 0.0},
    )


def w2_fields(phi):
    """Case 2: steady geostrophic zonal flow (u0 = one rotation in 12
    days)."""
    u0 = 2.0 * np.pi * A_EARTH / (12.0 * 86400.0)
    gh0 = 2.94e4
    h = (gh0 - (A_EARTH * OMEGA * u0 + u0 * u0 / 2.0) * np.sin(phi) ** 2) / G
    return h, u0 * np.cos(phi), np.zeros_like(phi)


def w6_fields(phi, lam, R=4, omega=7.848e-6, h0=8.0e3):
    """Case 6: Rossby-Haurwitz wave (Williamson et al. 1992, eqs 145-149)."""
    a, K = A_EARTH, omega
    c, s = np.cos(phi), np.sin(phi)
    u = a * omega * c + a * K * c ** (R - 1) * (R * s * s - c * c) * np.cos(R * lam)
    v = -a * K * R * c ** (R - 1) * s * np.sin(R * lam)
    A = omega / 2 * (2 * OMEGA + omega) * c * c + K * K / 4 * c ** (2 * R) * (
        (R + 1) * c * c + (2 * R * R - R - 2) - 2 * R * R * c ** (-2)
    )
    B = (
        2 * (OMEGA + omega) * K / ((R + 1) * (R + 2)) * c**R
        * ((R * R + 2 * R + 2) - (R + 1) ** 2 * c * c)
    )
    C = K * K / 4 * c ** (2 * R) * ((R + 1) * c * c - (R + 2))
    h = h0 + (a * a * A + a * a * B * np.cos(R * lam) + a * a * C * np.cos(2 * R * lam)) / G
    return h, u, v


def w5_fields(phi, lam):
    """Case 5: u0 = 20 m/s zonal flow, 5960 m mean surface, conical mountain
    h_s at (270E, 30N).  Returns (h_depth, u, v, h_s)."""
    u0 = 20.0
    h_surf = 5960.0 - (A_EARTH * OMEGA * u0 + u0 * u0 / 2.0) * np.sin(phi) ** 2 / G
    Rm, lc, pc = np.pi / 9, 1.5 * np.pi, np.pi / 6
    dlam = np.minimum(np.abs(lam - lc), 2 * np.pi - np.abs(lam - lc))
    rr = np.sqrt(np.minimum(Rm**2, dlam**2 + (phi - pc) ** 2))
    hs = 2000.0 * (1.0 - rr / Rm)
    return h_surf - hs, u0 * np.cos(phi), np.zeros_like(phi), hs


def w1_bell(phi, lam):
    """Case 1's cosine bell (500 m, radius a/3) centred at (270E, 0N)."""
    a = A_EARTH
    r = a * np.arccos(np.clip(np.cos(phi) * np.cos(lam - 1.5 * np.pi), -1, 1))
    return np.where(r < a / 3, 500.0 * (1 + np.cos(np.pi * r / (a / 3))), 0.0)


def setup_topography(grid, ctx, hs):
    """The spectrally filtered topography gradient into
    ctx.extras['hs_grad']; returns the filtered h_s (what the model feels)
    as numpy.  integrate_model does the same from
    options['topography_file'] (model._set_topography)."""
    pad = np.zeros((grid.nvars,) + grid.spatial_shape)
    pad[0] = hs
    f = grid.synthesis(grid.analysis(
        torch.as_tensor(pad, dtype=grid.dtype, device=grid.device)))
    ctx.extras["hs_grad"] = torch.stack([f["dr"][0], f["dl"][0]])
    return f["val"][0].cpu().numpy()


def w6_phase_speed(R=4, omega=7.848e-6):
    return (R * (3 + R) * omega - 2 * OMEGA) / ((1 + R) * (2 + R))


def run_case(model, phys0, n_steps, grid=None, ctx=None, device=DEFAULT):
    """``n_steps`` of ``model`` in float64 from the fields ``phys0`` [3,
    *spatial] on ``device`` (the card unless the caller asks for the CPU; a
    given ``grid`` brings its own); returns (grid, final fields as numpy)."""
    from .. import timeintegration as ti
    from ..model import build_context, build_step, make_scan

    dtype = torch.float64
    if grid is None:
        grid = create_grid(model.grid_params, dtype, device=device)
    if ctx is None:
        ctx = build_context(model, grid, dtype)
    spec0 = grid.analysis(torch.as_tensor(phys0, dtype=dtype, device=grid.device))
    state = ti.initial_state(spec0, phys0.shape, dtype)
    state = make_scan(build_step(model, grid, ctx, dtype), n_steps)(state)
    return grid, grid.synthesis(state.spec)["val"].cpu().numpy()


def williamson2_model(out_dir):
    """The configuration of ``models/williamson2_sphere.py`` (case 2, 32
    cells x 96, ts 300 s, one day, output every 12 h) with its IC CSV
    written into ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    model = build_model(ts=300.0, t_end=86400.0).with_(
        output_interval=43200.0,
        initial_conditions=os.path.join(out_dir, "williamson2_ics.csv"),
        output_dir=out_dir,
    )
    from ..io import _write_csv

    pts = create_grid(model.grid_params, torch.float64, device="cpu").gridpoints()
    h, u, v = w2_fields(pts[:, 0])
    _write_csv(model.initial_conditions, ["lat", "lon", "h", "u", "v"],
               np.concatenate([pts, np.stack([h, u, v], axis=1)], axis=1))
    return model


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    model = build_model(ts=300.0)
    grid = create_grid(model.grid_params, torch.float64, device=device)
    pts = grid.gridpoints()
    phi = pts[:, 0].reshape(grid.spatial_shape)
    lam = pts[:, 1].reshape(grid.spatial_shape)
    h2, u2, v2 = w2_fields(phi)
    _, out = run_case(model, np.stack([h2, u2, v2]), 5 * 288, grid=grid, device=device)
    l2 = np.sqrt(np.mean((out[0] - h2) ** 2)) / np.sqrt(np.mean(h2**2))
    print(f"W2 (steady zonal flow, 5 days): l2(h) = {l2:.2e}, "
          f"spurious |v|max = {np.abs(out[2]).max()*1e3:.1f} mm/s")
    model = build_model(ts=150.0)
    h6, u6, v6 = w6_fields(phi, lam)
    _, out = run_case(model, np.stack([h6, u6, v6]), 576, grid=grid, device=device)
    h_an, _, _ = w6_fields(phi, lam - w6_phase_speed() * 86400.0)
    corr = np.corrcoef(out[0].ravel(), h_an.ravel())[0, 1]
    print(f"W6 (Rossby-Haurwitz wave-4, 1 day): corr vs analytically-advected "
          f"= {corr:.5f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
