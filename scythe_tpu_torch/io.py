"""Grid I/O: CSV interchange (reference-compatible schema), the NaN
watchdog, and binary checkpoints in the JAX package's ``.npz`` layout.

The counterpart of ``scythe_tpu.io``: the same CSV schema (coordinate
columns then one column per variable, row order = the grid's flattened
point order), accelerated by the framework-free native extension
``scythe_native_io`` when it is importable.  NetCDF and spectral output are
not ported yet.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np

from .device import DEFAULT

try:  # optional native accelerator (native/scythe_io.cpp)
    import scythe_native_io as _nio  # type: ignore
except Exception:  # pragma: no cover - fallback path
    _nio = None


def _read_csv(path: str) -> tuple[list[str], np.ndarray]:
    if _nio is not None:
        names, nrows, ncols, raw = _nio.read_csv(path)
        data = np.frombuffer(raw, dtype=np.float64).reshape(nrows, ncols)
        return list(names), data
    with open(path) as f:
        header = f.readline().strip().split(",")
    data = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    return header, data


def _write_csv(path: str, names: list[str], cols: np.ndarray) -> None:
    if _nio is not None:
        arr = np.ascontiguousarray(cols, np.float64)
        _nio.write_csv(path, list(names), arr.data, arr.shape[0], arr.shape[1])
        return
    header = ",".join(names)
    np.savetxt(path, cols, delimiter=",", header=header, comments="", fmt="%.17g")


_COORD_NAMES = {
    "R": ["r"],
    "RL": ["r", "l"],
    "RZ": ["r", "z"],
    "RLZ": ["r", "l", "z"],
}


def read_physical_grid(path: str, grid) -> np.ndarray:
    """IC CSV -> [nvars, *spatial] float64 (ref read_physical_grid)."""
    if path.endswith(".nc"):
        raise NotImplementedError(
            "NetCDF initial conditions are not ported to scythe_tpu_torch yet"
        )
    names, data = _read_csv(path)
    p = grid.params
    npts = grid.num_points
    if data.shape[0] != npts:
        raise ValueError(
            f"IC file {path} has {data.shape[0]} rows; grid has {npts} points"
        )
    out = np.zeros((p.nvars,) + grid.spatial_shape)
    for v, name in enumerate(p.vars):
        if name not in names:
            raise ValueError(f"IC file missing variable column {name!r}")
        out[v] = data[:, names.index(name)].reshape(grid.spatial_shape)
    return out


def write_output(grid, model, t: float, phys: np.ndarray) -> str:
    """Write ``physical_out_<t>.csv`` (ref write_output, src/io.jl:3-13)."""
    if model.opts().get("output_format") == "nc":
        raise NotImplementedError(
            "options['output_format']='nc' is not ported to scythe_tpu_torch yet"
        )
    os.makedirs(model.output_dir, exist_ok=True)
    time = str(round(float(t), 2))
    path = os.path.join(model.output_dir, f"physical_out_{time}.csv")
    coords = grid.gridpoints()
    names = list(_COORD_NAMES[grid.geometry]) + list(grid.params.vars)
    cols = np.concatenate(
        [coords] + [np.asarray(phys[v]).reshape(-1, 1) for v in range(grid.nvars)],
        axis=1,
    )
    _write_csv(path, names, cols)
    return path


def save_checkpoint(path: str, state, t_sim: float) -> None:
    """Full-state binary checkpoint (spectral coefficients + multistep
    tendency history) in the layout of ``scythe_tpu.io.save_checkpoint``."""
    from .convert import state_to_numpy

    np.savez_compressed(path, **state_to_numpy(state), t_sim=np.asarray(t_sim))


def load_checkpoint(path: str, dtype=None, device: Any = DEFAULT):
    """Read a checkpoint written by either package onto ``device`` (the
    card unless the caller asks for the CPU); returns (state, t_sim)."""
    from .convert import state_from_numpy

    with np.load(path) as d:
        return state_from_numpy(d, device, dtype), float(d["t_sim"])


def check_cfl(grid, phys: np.ndarray) -> None:
    """Runtime health watchdog (ref checkCFL, semiimplicit.jl:737-751): NaN
    and +/-inf in any variable raise FloatingPointError."""
    for v, name in enumerate(grid.params.vars):
        bad = ~np.isfinite(np.asarray(phys[v]))
        if bad.any():
            idx = int(np.argwhere(bad.reshape(-1))[0][0])
            raise FloatingPointError(
                f"Non-finite value found in variable {name} at index {idx}! "
                "CFL condition likely violated"
            )
