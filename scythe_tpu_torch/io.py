"""Grid I/O: CSV interchange (reference-compatible schema), CF NetCDF
output and input, spectral CSV output, the NaN watchdog, and binary
checkpoints in the JAX package's ``.npz`` layout.

The counterpart of ``scythe_tpu.io``: the same CSV schema (coordinate
columns then one column per variable, row order = the grid's flattened
point order; read by the framework-free native extension
``scythe_native_io`` when it is importable, written by the port's own host
writer, ``ops/csrc/csv_writer.cpp``, which releases the GIL, so that
``model.run_loop``'s writer thread runs beside the run), and the same
NetCDF files (``scipy.io.netcdf_file``, classic format), so a file written
by one package reads in the other.
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
    """The CSV file: the port's host writer (``ops/csrc/csv_writer.cpp``),
    which formats with the GIL released, where a host C++ compiler built it;
    else numpy.  Both write the bytes of ``scythe_native_io.write_csv``."""
    from .ops import _build

    arr = np.ascontiguousarray(cols, np.float64)
    lib = _build.load_host()
    if lib is not None:
        header = (",".join(names) + "\n").encode()
        err = lib.scythe_write_csv(os.fsencode(path), header, len(header), arr.ctypes.data,
                                   arr.shape[0], arr.shape[1])
        if err:
            raise OSError(err, os.strerror(err), path)
        return
    header = ",".join(names)
    np.savetxt(path, cols, delimiter=",", header=header, comments="", fmt="%.17g")


_COORD_NAMES = {
    "R": ["r"],
    "RL": ["r", "l"],
    "RZ": ["r", "z"],
    "RLZ": ["r", "l", "z"],
    "XYZ": ["x", "y", "z"],
    "SL": ["lat", "lon"],
    "SLZ": ["lat", "lon", "z"],
}


def read_physical_grid(path: str, grid) -> np.ndarray:
    """IC CSV (or .nc) -> [nvars, *spatial] float64 (ref
    read_physical_grid)."""
    if path.endswith(".nc"):
        return read_physical_grid_nc(path, grid)
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
    """Write ``physical_out_<t>.csv`` (ref write_output, src/io.jl:3-13), or
    CF NetCDF when options['output_format'] == 'nc'."""
    if model.opts().get("output_format") == "nc":
        return write_output_nc(grid, model, t, phys)
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


def write_spectral(grid, model, t: float, spec) -> str:
    """Write ``spectral_out_<t>.csv`` (options['write_spectral']): the
    flattened coefficient index, then one column per variable."""
    os.makedirs(model.output_dir, exist_ok=True)
    time = str(round(float(t), 2))
    path = os.path.join(model.output_dir, f"spectral_out_{time}.csv")
    arr = spec.detach().cpu().numpy().astype(np.float64).reshape(grid.nvars, -1)
    idx = np.arange(arr.shape[1], dtype=np.float64).reshape(-1, 1)
    cols = np.concatenate([idx] + [arr[v].reshape(-1, 1) for v in range(grid.nvars)],
                          axis=1)
    _write_csv(path, ["coeff"] + list(grid.params.vars), cols)
    return path


_CF_COORDS = {
    "r": ("radius", "m"),
    "l": ("azimuth", "radian"),
    "z": ("height", "m"),
    "x": ("x", "m"),
    "y": ("y", "m"),
    "lat": ("latitude", "radian"),
    "lon": ("longitude", "radian"),
}


def _grid_coords(grid) -> dict[str, np.ndarray]:
    from .basis import fourier

    names = _COORD_NAMES[grid.geometry]
    out = {names[0]: np.asarray(grid.r_mish, np.float64)}
    for key in ("l", "lon"):
        if key in names:
            out[key] = fourier.angles(grid.nl)
    if "y" in names:
        out["y"] = grid._y_points()
    if "z" in names:
        out["z"] = np.asarray(grid.z_mish, np.float64)
    return out


def write_output_nc(grid, model, t: float, phys: np.ndarray) -> str:
    """``physical_out_<t>.nc``: CF-style NetCDF (classic format, scipy), the
    coordinate variables with their units, one [r(,l)(,z)] variable per
    model field, and the run's metadata as global attributes."""
    from scipy.io import netcdf_file

    os.makedirs(model.output_dir, exist_ok=True)
    time = str(round(float(t), 2))
    path = os.path.join(model.output_dir, f"physical_out_{time}.nc")
    dims = _COORD_NAMES[grid.geometry]
    coords = _grid_coords(grid)
    with netcdf_file(path, "w") as f:
        f.title = f"scythe-tpu {model.equation_set} output"
        f.equation_set = model.equation_set
        f.geometry = grid.geometry
        f.time_seconds = float(t)
        for d in dims:
            f.createDimension(d, len(coords[d]))
            cv = f.createVariable(d, "d", (d,))
            cv[:] = coords[d]
            cv.long_name, cv.units = _CF_COORDS[d]
        for v, name in enumerate(grid.params.vars):
            var = f.createVariable(name, "d", tuple(dims))
            var[:] = np.asarray(phys[v], np.float64)
    return path


def read_physical_grid_nc(path: str, grid) -> np.ndarray:
    """The NetCDF counterpart of ``read_physical_grid`` (ICs or restart)."""
    from scipy.io import netcdf_file

    p = grid.params
    out = np.zeros((p.nvars,) + grid.spatial_shape)
    with netcdf_file(path, "r", mmap=False) as f:
        for v, name in enumerate(p.vars):
            if name not in f.variables:
                raise ValueError(f"NetCDF file missing variable {name!r}")
            data = np.asarray(f.variables[name][:], np.float64)
            if data.shape != grid.spatial_shape:
                raise ValueError(
                    f"{path}:{name} has shape {data.shape}; grid needs "
                    f"{grid.spatial_shape}"
                )
            out[v] = data
    return out


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
