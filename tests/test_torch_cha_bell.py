"""The Cha & Bell workflow of scythe_tpu_torch against the JAX package's
(examples/cha_bell_initialization.py, models/cha_bell2024/): the model
functions give the model files' configurations; the Rankine and wave-2 IC
files are array-equal at 16 cells x 16 azimuths; a short spinup plus two-way
run through integrate_model agrees within 1e-9 of each field's max|ref|
(float64 on the CPU).
"""

import dataclasses
import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scythe_tpu as jx
from scythe_tpu import io as jio

import scythe_tpu_torch as tx
from scythe_tpu_torch import io as tio
from scythe_tpu_torch.examples import cha_bell_initialization as cb

from test_torch_shallow_water import per_var_close

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "models", "cha_bell2024")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_side():
    """The JAX example and its three model files, loaded from their paths;
    what they put on sys.path and in sys.modules is taken out again."""
    path, mods = list(sys.path), set(sys.modules)
    sys.path.insert(0, MODELS)
    try:
        out = {n: _load(os.path.join(MODELS, f"{n}.py"), f"_cha_bell_{n}")
               for n in ("oneway_spinup", "oneway", "twoway")}
        out["example"] = _load(os.path.join(REPO, "examples", "cha_bell_initialization.py"),
                               "_cha_bell_example")
    finally:
        sys.path[:] = path
        for m in set(sys.modules) - mods:
            if not m.startswith(("scythe_tpu", "jax")):
                del sys.modules[m]
    return out


def _same_model(mt, mj, base):
    for k in ("ts", "integration_time", "output_interval", "equation_set"):
        assert getattr(mt, k) == getattr(mj, k), k
    assert mt.phys() == mj.phys() and mt.opts() == mj.opts()
    gt, gj = mt.grid_params, mj.grid_params
    for k in ("geometry", "xmin", "xmax", "num_cells", "lDim", "l_q", "vars"):
        assert getattr(gt, k) == getattr(gj, k), k
    for side in ("BCL", "BCR"):
        assert [b.name for b in getattr(gt, side)] == [b.name for b in getattr(gj, side)]
    for k in ("initial_conditions", "output_dir"):
        assert os.path.normpath(getattr(mt, k)) == os.path.normpath(
            os.path.join(base, getattr(mj, k))), k


@pytest.mark.parametrize("name,make", [("oneway_spinup", cb.spinup_model),
                                          ("oneway", cb.oneway_model),
                                          ("twoway", cb.twoway_model)])
def test_model_functions_give_the_model_files(jax_side, name, make):
    _same_model(make("base"), jax_side[name].model, "base")
    assert make("base").grid_params.rDim == 300
    assert make("base").grid_params.b_rDim == 103


def test_constants_and_profiles_match(jax_side):
    ex = jax_side["example"]
    for k in ("RMAX", "VMAX", "F_COR", "EPSILON", "G"):
        assert getattr(cb, k) == getattr(ex, k)
    r = np.random.default_rng(0).uniform(100.0, 3.0e5, 500)
    assert np.array_equal(cb.rankine_profile(r), ex.rankine_profile(r))
    v = ex.rankine_profile(r)
    assert np.array_equal(cb.balanced_height(r, v), ex.balanced_height(r, v))


def _small(model, tmp, sub, **kw):
    """``model`` on a 16 x 16 grid with its files under ``tmp``."""
    gp = dataclasses.replace(model.grid_params, num_cells=16, lDim=16)
    return model.with_(
        grid_params=gp,
        initial_conditions=str(tmp / sub / os.path.basename(model.initial_conditions)),
        output_dir=str(tmp / sub), **kw)


def test_ic_files_and_short_run_match(jax_side, tmp_path):
    ex = jax_side["example"]
    # ---- stage 1: the Rankine ICs, array-equal
    sp_j = _small(jax_side["oneway_spinup"].model, tmp_path, "jax_spinup",
                  integration_time=60.0, output_interval=30.0)
    sp_t = _small(cb.spinup_model(str(tmp_path)), tmp_path, "torch_spinup",
                  integration_time=60.0, output_interval=30.0)
    gj = jx.create_grid(sp_j.grid_params, jnp.float64)
    gt = tx.create_grid(sp_t.grid_params, torch.float64, device="cpu")
    assert np.array_equal(gt.gridpoints(), gj.gridpoints())
    ex.write_rankine_ics(gj, sp_j.initial_conditions)
    cb.write_rankine_ics(gt, sp_t.initial_conditions)
    nj, dj = jio._read_csv(sp_j.initial_conditions)
    nt, dt = tio._read_csv(sp_t.initial_conditions)
    assert nt == nj == cb.IC_COLUMNS and np.array_equal(dt, dj)

    # ---- stage 2: 20 spinup steps through integrate_model
    _, pj = jx.integrate_model(sp_j, dtype=jnp.float64)
    _, pt = tx.integrate_model(sp_t, dtype=torch.float64, device="cpu")
    per_var_close(pt, pj, 1e-9, "spinup")
    assert sorted(os.listdir(sp_t.output_dir)) == sorted(os.listdir(sp_j.output_dir))

    # ---- stage 3: wave 2 on the same balanced file, array-equal; on each
    # package's own spinup output, equal within the runs' difference
    balanced_j = os.path.join(sp_j.output_dir, "physical_out_60.0.csv")
    balanced_t = os.path.join(sp_t.output_dir, "physical_out_60.0.csv")
    tw_j = _small(jax_side["twoway"].model, tmp_path, "jax_twoway",
                  integration_time=60.0, output_interval=60.0)
    tw_t = _small(cb.twoway_model(str(tmp_path)), tmp_path, "torch_twoway",
                  integration_time=60.0, output_interval=60.0)
    ex.add_wave2(gj, balanced_j, tw_j.initial_conditions)
    same = str(tmp_path / "same" / "wave2.csv")
    cb.add_wave2(gt, balanced_j, same)
    assert np.array_equal(tio._read_csv(same)[1], jio._read_csv(tw_j.initial_conditions)[1])
    cb.add_wave2(gt, balanced_t, tw_t.initial_conditions)
    ic_t = tio.read_physical_grid(tw_t.initial_conditions, gt)
    per_var_close(ic_t, jio.read_physical_grid(tw_j.initial_conditions, gj), 1e-9)
    amp = np.abs(np.fft.rfft(ic_t[2], axis=1))[:, 2].max() / 8.0
    assert amp > 1.0  # the wavenumber-2 part of vg, m/s

    # ---- stage 4: 20 two-way steps from each package's own wave-2 file
    _, pj = jx.integrate_model(tw_j, dtype=jnp.float64)
    _, pt = tx.integrate_model(tw_t, dtype=torch.float64, device="cpu")
    per_var_close(pt, pj, 1e-9, "twoway")
    a = np.loadtxt(os.path.join(tw_j.output_dir, "physical_out_60.0.csv"), delimiter=",",
                   skiprows=1)
    b = np.loadtxt(os.path.join(tw_t.output_dir, "physical_out_60.0.csv"), delimiter=",",
                   skiprows=1)
    per_var_close(b.T[2:], a.T[2:], 1e-9, "csv")
    assert np.abs(pt[5]).max() > 0.0  # wb, the override, reached the output


def test_initialize_wave2_writes_both_ic_files(tmp_path):
    gp = cb.cha_bell_grid(8, 8)
    model = cb.initialize_wave2(str(tmp_path), quick=True, dtype=torch.float64,
                                grid_params=gp, device="cpu")
    assert model.num_ts == 200 and model.equation_set == "Oneway_ShallowWater_Slab"
    for m in (cb.oneway_model(str(tmp_path), gp), cb.twoway_model(str(tmp_path), gp)):
        names, data = tio._read_csv(m.initial_conditions)
        assert names == cb.IC_COLUMNS and data.shape == (24 * 8, 8)
        assert np.isfinite(data).all()


def test_example_entry_point_runs_on_the_cpu(tmp_path, capsys):
    import unittest.mock as mock

    small = cb.cha_bell_grid(8, 8)
    with mock.patch.object(cb, "cha_bell_grid", lambda *a, **k: small):
        assert cb.main(["--quick", "--cpu", "--dir", str(tmp_path)]) == 0
    assert os.path.exists(tmp_path / "Twoway_SWslab_wave2" / "SWslab_wave2.csv")
    assert "Done" in capsys.readouterr().out
