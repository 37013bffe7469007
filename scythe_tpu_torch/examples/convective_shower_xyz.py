"""3-D convective shower in the Cartesian XYZ box (MoistEulerXYZ), in
PyTorch: the port of ``examples/convective_shower_xyz.py``.

A warm, moist thermal in a conditionally unstable, sheared box, periodic in
x and y, grows a cloud and rains out through the floor (active
sedimentation).  ``build_model`` keeps the JAX example's defaults (48 cells
x ny 16 x nz 32, 60 km x 20 km x 15 km, ts 0.25 s, 2,700 s) and writes its
sounding; ``write_ics`` writes the thermal, its +30% moisture excess and the
low-level shear to the IC CSV with the port's thermodynamics.

    python -m scythe_tpu_torch.examples.convective_shower_xyz [--cpu]
        [--time 2700] [--profile moist_production] [--dir shower_out]

``profile='moist_production'`` adds the JAX package's stable moist bundle
(variable-coefficient semi-implicit solve, diagnostic condensation, the
modal filter, exp stiff relaxation) over the example's options.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import BC, ZBC, GridParameters, ModelParameters, create_grid
from ..physics import thermodynamics as td

VARS = {
    "s": 1, "xi": 2, "mu": 3, "u": 4, "v": 5, "w": 6,
    "mu_c": 7, "mu_r": 8, "qss": 9,
}


def build_model(out_dir, num_cells=48, ny=16, nz=32, ts=0.25, t_end=2700.0):
    """The example's ModelParameters, its sounding written under
    ``out_dir``: a Weisman-Klemp theta profile with a moist boundary layer,
    dry above 9 km."""
    os.makedirs(out_dir, exist_ok=True)
    zs = np.linspace(0.0, 18000.0, 80)
    ztr, thtr, ttr = 12000.0, 343.0, 213.0
    theta = np.where(
        zs <= ztr,
        300.0 + 43.0 * (zs / ztr) ** 1.25,
        thtr * np.exp(9.81 / (1004.0 * ttr) * (zs - ztr)),
    )
    qv = np.where(zs <= 1200.0, 13.0, 13.0 * np.exp(-(zs - 1200.0) / 2200.0))
    qv = np.where(zs > 9000.0, 0.02, qv)
    sounding = os.path.join(out_dir, "sounding.txt")
    with open(sounding, "w") as f:
        f.write(f"1000.0 {theta[0]} {qv[0]}\n")
        for z, th, q in zip(zs[1:], theta[1:], qv[1:]):
            f.write(f"{z} {th} {q}\n")

    gp = GridParameters(
        geometry="XYZ",
        xmin=-30000.0,
        xmax=30000.0,
        num_cells=num_cells,
        lDim=ny,
        ymin=0.0,
        ymax=20000.0,
        zmin=0.0,
        zmax=15000.0,
        zDim=nz,
        BCL={n: BC.PERIODIC for n in VARS},
        BCR={n: BC.PERIODIC for n in VARS},
        # insulated (R1T1) tops and bottoms for the diffused scalars, but an
        # unconstrained rain bottom so surface rain can drain (the JAX
        # example's measured choices)
        BCB={"s": ZBC.R1T1, "u": ZBC.R1T1, "v": ZBC.R1T1, "mu": ZBC.R1T1,
             "mu_c": ZBC.R1T1, "w": ZBC.R1T0},
        BCT={"s": ZBC.R1T1, "u": ZBC.R1T1, "v": ZBC.R1T1, "mu": ZBC.R1T1,
             "mu_c": ZBC.R1T1, "mu_r": ZBC.R1T1, "w": ZBC.R1T0},
        vars=VARS,
    )
    return ModelParameters(
        ts=ts,
        integration_time=t_end,
        output_interval=t_end / 6.0,
        equation_set="MoistEulerXYZ",
        initial_conditions=os.path.join(out_dir, "ics.csv"),
        output_dir=out_dir,
        ref_state_file=sounding,
        grid_params=gp,
        physical_params={"K": 50.0},
        options={"semiimplicit": True, "sedimentation": "active"},
    )


def write_ics(model, grid, ref_state):
    """The IC CSV at ``model.initial_conditions``: a warm (+~3 K), moist
    (+30% qv) thermal with a y modulation, plus low-level shear; the JAX
    example's fields."""
    from ..io import _write_csv

    pts = grid.gridpoints()
    x = pts[:, 0].reshape(grid.spatial_shape)
    y = pts[:, 1].reshape(grid.spatial_shape)
    z = pts[:, 2].reshape(grid.spatial_shape)
    ly = float(model.grid_params.ymax - model.grid_params.ymin)
    rad = np.sqrt((x / 10000.0) ** 2 + ((z - 1400.0) / 1400.0) ** 2)
    shape = (
        np.maximum(0.0, np.cos(np.pi * np.minimum(rad, 1.0) / 2.0)) ** 2
        * (1.0 + 0.15 * np.cos(2.0 * np.pi * y / ly))
    )
    mubar = ref_state.mubar[:, 0].detach().cpu().double()
    qv_bar = td.ahyp(mubar).numpy()[None, None, :] * np.ones_like(z)
    mu_pert = (td.bhyp(torch.from_numpy(qv_bar * (1.0 + 0.30 * shape))).numpy()
               - mubar.numpy()[None, None, :])
    cols = {
        "s": 10.0 * shape,
        "mu": mu_pert,
        "u": np.where(z <= 3000.0, -10.0 * (1.0 - z / 3000.0), 0.0),
    }
    names = list(model.grid_params.vars)
    data = np.zeros((pts.shape[0], 3 + len(names)))
    data[:, :3] = pts
    for j, n in enumerate(names):
        if n in cols:
            data[:, 3 + j] = cols[n].ravel()
    _write_csv(model.initial_conditions, ["x", "y", "z", *names], data)


def shower_model(out_dir, profile=None, **kw):
    """``build_model(out_dir, **kw)`` with its ICs written (the grid built
    on the CPU for them); ``profile`` names an options profile to put over
    the example's options."""
    from ..model import build_context

    model = build_model(out_dir, **kw)
    if profile:
        model = model.with_(options={**dict(model.options), "profile": profile})
    grid = create_grid(model.grid_params, torch.float64, device="cpu")
    write_ics(model, grid, build_context(model, grid, torch.float64).ref_state)
    return model


def readings(phys) -> dict:
    """What the example prints, from final fields [9, *spatial] (numpy):
    the w range, the cloud water and rain maxima, surface rain (lowest four
    levels), in m/s and kg/kg."""
    vi = list(VARS).index
    qc = td.ahyp(torch.from_numpy(np.asarray(phys[vi("mu_c")], np.float64))).numpy()
    qr = td.ahyp(torch.from_numpy(np.asarray(phys[vi("mu_r")], np.float64))).numpy()
    w = phys[vi("w")]
    return {"w_min": float(w.min()), "w_max": float(w.max()),
            "qc_max": float(qc.max()), "qr_max": float(qr.max()),
            "qr_surface_max": float(qr[:, :, :4].max())}


def main(argv=None):
    from .. import integrate_model

    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--time", type=float, default=2700.0)
    ap.add_argument("--profile", default=None)
    ap.add_argument("--dir", default="./convective_shower_out")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    dtype = torch.float64 if args.cpu else torch.float32
    model = shower_model(args.dir, profile=args.profile, t_end=args.time)
    _, phys = integrate_model(model, dtype=dtype, device=device)
    r = readings(phys)
    print(
        f"t = {args.time:.0f} s: w in ({r['w_min']:.1f}, {r['w_max']:.1f}) m/s, "
        f"cloud water max {r['qc_max']*1e3:.2f} g/kg, rain max "
        f"{r['qr_max']*1e3:.2f} g/kg (surface {r['qr_surface_max']*1e3:.2f})"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
