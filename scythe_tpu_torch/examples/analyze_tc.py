"""Analyze a two-layer TC run directory, in PyTorch: the port of
``examples/analyze_tc.py``.

Prints a per-output-time table (Vmax free layer / BL, minimum h, RMW) and
the final-state azimuthal vorticity power spectrum, the quantities the
Cha & Bell (2024) analysis is built on; with ``--empi-sounding``, the
Emanuel potential intensity of a sounding (and a simulated Vmax against
it).  The grid comes from ``--model`` (a config file defining ``model``),
by default the port's copy of ``models/cha_bell2024/twoway.py``.

Run:  python -m scythe_tpu_torch.examples.analyze_tc <run_dir> [--cpu]
      [--model CONFIG.py] [--empi-sounding FILE [--sst K] [--vmax M/S]]
(the spectrum's transforms run on the card unless --cpu is given.)
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import runpy
import sys

import numpy as np
import torch

from .. import create_grid
from .. import diagnostics as dg
from .. import io as sio
from ..device import DEFAULT

DEFAULT_MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "models", "cha_bell2024", "twoway.py")
_OUT_TIME = re.compile(r"physical_out_(.*)\.(?:csv|nc)")


def output_files(run_dir) -> list[tuple[float, str]]:
    """(t, path) of the run's physical_out_*.csv / .nc files, in time order."""
    paths = (glob.glob(os.path.join(run_dir, "physical_out_*.csv"))
             + glob.glob(os.path.join(run_dir, "physical_out_*.nc")))
    return sorted((float(_OUT_TIME.search(p).group(1)), p) for p in paths)


def intensity_row(grid, phys) -> tuple[float, float, float, float]:
    """(Vmax free layer m/s, Vmax BL m/s, h_min m, RMW km) of fields
    [nvars, *spatial]: the RMW at the largest azimuthal-mean v."""
    vi = grid.params.var_index
    vbar = phys[vi("v")].mean(axis=1)
    return (float(phys[vi("v")].max()), float(phys[vi("vb")].max()),
            float(phys[vi("h")].min()), float(grid.r_mish[int(np.argmax(vbar))]) / 1000.0)


def vorticity_spectrum(grid, phys, kmax=6) -> np.ndarray:
    """Azimuthal power of the relative vorticity of fields [nvars, *spatial]
    (numpy) for wavenumbers 0..kmax-1, relative to k = 0."""
    vi = grid.params.var_index
    fields = grid.synthesis(grid.analysis(
        torch.as_tensor(phys, dtype=grid.dtype, device=grid.device)))
    zeta = dg.relative_vorticity(fields, grid.coords()["r"], vi("u"), vi("v"))
    power = np.abs(np.fft.rfft(zeta.cpu().numpy(), axis=1)).mean(axis=0)
    return power[:kmax] / (power[0] + 1e-30)


def potential_intensity(sounding, sst):
    """(E-MPI m/s, outflow T K, air-sea disequilibrium J/kg) of a sounding
    file, through the port's reference-state builder (hydrostatic theta to
    T inversion on 48 levels to 20 km) and thermodynamics."""
    from ..physics import reference_state as rsmod
    from ..physics import thermodynamics as td

    rs = rsmod.interpolate_reference_file(sounding, 0.0, 20.0e3, 48, 33, torch.float64,
                                          device="cpu")
    q_v, _, Tk, phPa = (a.numpy() for a in td.thermodynamic_tuple(
        rs.sbar[:, 0], rs.xibar[:, 0], rs.mubar[:, 0]))
    return dg.emanuel_potential_intensity(Tk, phPa, q_v, sst)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir", nargs="?", default="-")
    ap.add_argument("--model", default=DEFAULT_MODEL,
                    help="model config file (for the grid)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    ap.add_argument("--empi-sounding", default=None,
                    help="sounding file (z theta qv; first line surface "
                    "pressure): print the Emanuel potential intensity of "
                    "that environment and the simulated overshoot vs "
                    "--vmax (diagnostics.emanuel_potential_intensity)")
    ap.add_argument("--sst", type=float, default=301.15,
                    help="sea-surface temperature [K] for --empi-sounding")
    ap.add_argument("--vmax", type=float, default=None,
                    help="simulated peak intensity [m/s] to compare against E-MPI")
    args = ap.parse_args(argv)

    if args.empi_sounding:
        vmpi, To, dk = potential_intensity(args.empi_sounding, args.sst)
        print(f"E-MPI of {args.empi_sounding} at SST {args.sst:.2f} K: "
              f"{vmpi:.1f} m/s  (outflow T {To:.1f} K, "
              f"air-sea disequilibrium {dk:.0f} J/kg)")
        if args.vmax is not None:
            print(f"simulated Vmax {args.vmax:.1f} m/s = "
                  f"{args.vmax / vmpi:.2f}x E-MPI "
                  "(axisymmetric superintensity up to ~1.5x is the "
                  "known regime: Persing & Montgomery 2003)")
        if not args.run_dir or args.run_dir == "-":
            return 0

    gp = runpy.run_path(args.model)["model"].grid_params
    grid = create_grid(gp, torch.float64, device="cpu" if args.cpu else DEFAULT)
    files = output_files(args.run_dir)
    if not files:
        sys.exit(f"no physical_out_*.csv or .nc in {args.run_dir}")

    print(f"{'t[s]':>10} {'Vmax(free)':>11} {'Vmax(BL)':>9} {'h_min':>8} {'RMW[km]':>8}")
    for t, path in files:
        vmax, vbmax, hmin, rmw = intensity_row(grid, sio.read_physical_grid(path, grid))
        print(f"{t:>10.0f} {vmax:>11.2f} {vbmax:>9.2f} {hmin:>8.1f} {rmw:>8.1f}")

    rel = vorticity_spectrum(grid, sio.read_physical_grid(files[-1][1], grid))
    print("\nfinal azimuthal vorticity power (rel to k=0):")
    for k, p in enumerate(rel):
        print(f"  k={k}: {p:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
