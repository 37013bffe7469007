"""The I/O and run-loop extras of scythe_tpu_torch against scythe_tpu: CF
NetCDF output and input, spectral CSV output, checkpoints written by
options['checkpoint_interval'] and resumed from, and the profiler trace of
``profile_dir``.

Float64 on the CPU.  A file written by either package reads in the other:
NetCDF fields bitwise, checkpoints bitwise, a run resumed in the port from a
checkpoint of its own bitwise equal to the continuous run, and one resumed
across packages within 1e-12 of each field's max.  The mirrors of
tests/test_io.py (NetCDF round trip, missing variable, spectral file) and
tests/test_resume.py::test_resume_matches_continuous keep their bounds.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scythe_tpu as jx
import scythe_tpu.io as jio

import scythe_tpu_torch as tx
import scythe_tpu_torch.io as tio

from test_torch_shallow_water import per_var_close

torch.set_num_threads(2)


def _rl_params(pkg):
    return pkg.GridParameters(
        geometry="RL", xmin=0.0, xmax=1.0e5, num_cells=8, lDim=16,
        BCL={"h": pkg.BC.R1T1, "u": pkg.BC.R1T0}, BCR={"h": pkg.BC.R0, "u": pkg.BC.R0},
        vars={"h": 1, "u": 2},
    )


def _rl_model(pkg, tmp_path, options=None, out="out"):
    return pkg.ModelParameters(
        ts=1.0, integration_time=1.0, output_interval=1.0,
        equation_set="LinearAdvectionRL", initial_conditions="unused.csv",
        output_dir=str(tmp_path / out), grid_params=_rl_params(pkg),
        options=options or {"output_format": "nc"},
    )


# ------------------------------------------------- mirrors of tests/test_io.py


def test_netcdf_output_roundtrip(tmp_path):
    from scipy.io import netcdf_file

    model = _rl_model(tx, tmp_path)
    grid = tx.create_grid(model.grid_params, torch.float64, device="cpu")
    phys = np.random.default_rng(0).normal(size=(2,) + grid.spatial_shape)
    path = tio.write_output(grid, model, 42.0, phys)
    assert path.endswith("physical_out_42.0.nc")
    with netcdf_file(path, "r", mmap=False) as f:
        assert f.geometry.decode() == "RL"
        assert float(f.time_seconds) == 42.0
        np.testing.assert_allclose(f.variables["r"][:], grid.r_mish)
        assert f.variables["r"].units == b"m"
        assert f.variables["h"].shape == grid.spatial_shape
    back = tio.read_physical_grid(path, grid)
    np.testing.assert_array_equal(back, phys)


def test_netcdf_missing_variable_errors(tmp_path):
    from scipy.io import netcdf_file

    gp = tx.GridParameters(geometry="R", xmin=0.0, xmax=1.0, num_cells=4,
                           BCL={"u": tx.BC.R0}, BCR={"u": tx.BC.R0}, vars={"u": 1})
    grid = tx.create_grid(gp, torch.float64, device="cpu")
    path = str(tmp_path / "bad.nc")
    with netcdf_file(path, "w") as f:
        f.createDimension("r", 12)
    with pytest.raises(ValueError, match="missing variable"):
        tio.read_physical_grid(path, grid)
    with netcdf_file(path, "w") as f:
        f.createDimension("r", 5)
        f.createVariable("u", "d", ("r",))[:] = np.zeros(5)
    with pytest.raises(ValueError, match="shape"):
        tio.read_physical_grid(path, grid)


def test_write_spectral(tmp_path):
    gp = tx.GridParameters(geometry="R", xmin=0.0, xmax=10.0, num_cells=8,
                           BCL={"u": tx.BC.PERIODIC}, BCR={"u": tx.BC.PERIODIC},
                           vars={"u": 1})
    model = tx.ModelParameters(
        ts=0.1, integration_time=1.0, output_interval=1.0, equation_set="LinearAdvection1D",
        initial_conditions="unused", output_dir=str(tmp_path), grid_params=gp,
        physical_params={"c_0": 1.0, "K": 0.0}, options={"write_spectral": True},
    )
    grid = tx.create_grid(gp, torch.float64, device="cpu")
    spec = grid.analysis(torch.from_numpy(np.sin(2 * np.pi * grid.r_mish / 10.0)[None]))
    path = tio.write_spectral(grid, model, 0.0, spec)
    names, data = tio._read_csv(path)
    assert names == ["coeff", "u"]
    np.testing.assert_array_equal(data[:, 1], spec[0].numpy())
    np.testing.assert_array_equal(data[:, 0], np.arange(gp.b_rDim))


# --------------------------- NetCDF and spectral files across the packages


def _grids(kind):
    """(JAX grid, port grid) of one geometry, two variables."""
    import test_torch_slz as slz
    import test_torch_sphere as sph
    import test_torch_xyz as xyz

    params = {
        "RL": _rl_params,
        "XYZ": lambda pkg: xyz.xyz_params(pkg, vars_map=("s", "u")),
        "SL": lambda pkg: sph.sl_params(pkg, vars_map=("h", "u")),
        "SLZ": lambda pkg: slz.slz_params(pkg, vars_map=("s", "u")),
    }[kind]
    return (jx.create_grid(params(jx), jnp.float64),
            tx.create_grid(params(tx), torch.float64, device="cpu"))


@pytest.mark.parametrize("kind", ["RL", "XYZ", "SL", "SLZ"])
def test_netcdf_and_csv_cross_the_packages(kind, tmp_path):
    """What one package writes the other reads back bitwise, on every
    geometry, with the same coordinate names."""
    from scipy.io import netcdf_file

    gj, gt = _grids(kind)
    phys = np.random.default_rng(5).normal(size=(2,) + gt.spatial_shape)
    for fmt in ("nc", "csv"):
        opts = {"output_format": "nc"} if fmt == "nc" else {"output_format": "csv"}
        mj = _rl_model(jx, tmp_path, opts, out=f"jax_{fmt}").with_(grid_params=gj.params)
        mt = _rl_model(tx, tmp_path, opts, out=f"torch_{fmt}").with_(grid_params=gt.params)
        pj = jio.write_output(gj, mj, 7.5, phys)
        pt = tio.write_output(gt, mt, 7.5, phys)
        assert os.path.basename(pj) == os.path.basename(pt) == f"physical_out_7.5.{fmt}"
        np.testing.assert_array_equal(tio.read_physical_grid(pj, gt), phys)
        np.testing.assert_array_equal(jio.read_physical_grid(pt, gj), phys)
        if fmt == "csv":
            with open(pj) as a, open(pt) as b:
                assert a.readline() == b.readline()
            continue
        with netcdf_file(pj, "r", mmap=False) as a, netcdf_file(pt, "r", mmap=False) as b:
            assert sorted(a.variables) == sorted(b.variables)
            assert a.dimensions == b.dimensions
            for k in a.variables:
                np.testing.assert_array_equal(a.variables[k][:], b.variables[k][:])
                assert getattr(a.variables[k], "units", None) == getattr(
                    b.variables[k], "units", None)
            assert a.geometry == b.geometry and a.title == b.title


def _adv_params(pkg):
    return pkg.GridParameters(geometry="R", xmin=-50.0, xmax=50.0, num_cells=60,
                              BCL={"u": pkg.BC.PERIODIC}, BCR={"u": pkg.BC.PERIODIC},
                              vars={"u": 1})


def _adv_model(pkg, tmp_path, T, outdir, options=()):
    """tests/test_resume.py's configuration (R, 60 cells, periodic), its IC
    CSV written once."""
    model = pkg.ModelParameters(
        ts=0.05, integration_time=T, output_interval=T / 2,
        equation_set="LinearAdvection1D", initial_conditions=str(tmp_path / "ics.csv"),
        output_dir=str(tmp_path / outdir), grid_params=_adv_params(pkg),
        physical_params={"c_0": 1.0, "K": 0.05}, options=dict(options),
    )
    if not os.path.exists(model.initial_conditions):
        r = tx.create_grid(_adv_params(tx), torch.float64, device="cpu").r_mish
        tio._write_csv(model.initial_conditions, ["r", "u"],
                       np.stack([r, np.exp(-((r / 15.0) ** 2))], axis=1))
    return model


def _run(pkg, model, **kw):
    if pkg is tx:
        return tx.integrate_model(model, dtype=torch.float64, device="cpu", **kw)
    return jx.integrate_model(model, dtype=jnp.float64, **kw)


def test_resume_matches_continuous(tmp_path):
    """tests/test_resume.py's gate on the port, bitwise: 10 s with a
    checkpoint from options['checkpoint_interval'], resumed for 10 more."""
    full = _adv_model(tx, tmp_path, 20.0, "full")
    _, phys_full = _run(tx, full, write_outputs=False)
    first = _adv_model(tx, tmp_path, 10.0, "first", {"checkpoint_interval": 10.0})
    _run(tx, first)
    ckpt = os.path.join(first.output_dir, "checkpoint_10.0.npz")
    assert os.path.exists(ckpt)
    assert sorted(f for f in os.listdir(first.output_dir) if f.startswith("checkpoint")) == [
        "checkpoint_10.0.npz"]  # at output boundaries that are multiples of it
    second = _adv_model(tx, tmp_path, 10.0, "second")
    _, phys_resumed = _run(tx, second, resume_from=ckpt)
    np.testing.assert_array_equal(phys_resumed, phys_full)
    assert os.path.exists(os.path.join(second.output_dir, "physical_out_20.0.csv"))


def test_checkpoint_interval_writes_at_each_multiple(tmp_path):
    m = _adv_model(tx, tmp_path, 2.0, "every", {"checkpoint_interval": 0.5}).with_(
        output_interval=0.25)
    _run(tx, m)
    assert sorted(f for f in os.listdir(m.output_dir) if f.startswith("checkpoint")) == [
        "checkpoint_0.5.npz", "checkpoint_1.0.npz", "checkpoint_1.5.npz",
        "checkpoint_2.0.npz"]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_the_packages(writer, tmp_path):
    """A checkpoint written by one package's checkpoint_interval is the
    other's (bitwise, names and layout alike), and the other package resumes
    from it to the continuous run within 1e-12."""
    pw, pr = (jx, tx) if writer == "jax" else (tx, jx)
    full = _adv_model(pr, tmp_path, 20.0, "full")
    _, phys_full = _run(pr, full, write_outputs=False)
    for pkg, out in ((jx, "first_jax"), (tx, "first_torch")):
        _run(pkg, _adv_model(pkg, tmp_path, 10.0, out, {"checkpoint_interval": 10.0}))
    a = np.load(tmp_path / "first_jax" / "checkpoint_10.0.npz")
    b = np.load(tmp_path / "first_torch" / "checkpoint_10.0.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-12 * max(np.abs(a[k]).max(), 1))
    ckpt = os.path.join(tmp_path, f"first_{writer}", "checkpoint_10.0.npz")
    _, phys = _run(pr, _adv_model(pr, tmp_path, 10.0, "second"), resume_from=ckpt)
    per_var_close(phys, phys_full, 1e-12)


@pytest.mark.parametrize("option", ["write_spectral", "output_format"])
def test_run_loop_files_match_jax(option, tmp_path):
    """integrate_model with options['write_spectral'] or output_format='nc'
    writes the JAX package's files: the same names, fields within 1e-12."""
    opts = {"write_spectral": True} if option == "write_spectral" else {"output_format": "nc"}
    runs = {}
    for pkg, name in ((jx, "jax"), (tx, "torch")):
        m = _adv_model(pkg, tmp_path, 1.0, name, opts)
        _run(pkg, m)
        runs[name] = sorted(os.listdir(m.output_dir))
    assert runs["jax"] == runs["torch"]
    kind = "spectral_out_" if option == "write_spectral" else "physical_out_"
    files = [f for f in runs["torch"] if f.startswith(kind)]
    assert len(files) == 3
    grid = tx.create_grid(_adv_model(tx, tmp_path, 1.0, "x").grid_params, torch.float64,
                          device="cpu")
    for f in files:
        if option == "write_spectral":
            a = tio._read_csv(str(tmp_path / "jax" / f))[1]
            b = tio._read_csv(str(tmp_path / "torch" / f))[1]
        else:
            a = tio.read_physical_grid(str(tmp_path / "jax" / f), grid)
            b = tio.read_physical_grid(str(tmp_path / "torch" / f), grid)
        assert np.abs(b - a).max() <= 1e-12 * np.abs(a).max(), f


# ------------------------------------------------- the trace and the log


def test_profile_dir_leaves_a_trace(tmp_path):
    m = _adv_model(tx, tmp_path, 0.5, "prof")
    _run(tx, m, write_outputs=False, profile_dir=str(tmp_path / "trace"))
    path = tmp_path / "trace" / "trace.json"
    assert path.exists() and path.stat().st_size > 0
    import json

    events = json.loads(path.read_text())["traceEvents"]
    assert any("einsum" in str(e.get("name", "")) for e in events)


def test_done_line_gives_grid_point_steps(tmp_path):
    m = _adv_model(tx, tmp_path, 0.5, "log")
    _run(tx, m, write_outputs=False)
    with open(os.path.join(m.output_dir, "scythe_out.log")) as f:
        done = [ln for ln in f if ln.startswith("Done:")]
    assert len(done) == 1 and "grid-point-steps/s" in done[0], done
