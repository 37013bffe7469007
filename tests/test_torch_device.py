"""The port's entry points run on the card unless the caller asks for the CPU.

Their ``device`` defaults to "cuda"; without a card a call that gives no
device raises (decided inside each test, never at import); the helpers
that build operators take their device from the caller, with no default;
and every call of the port that takes a device, in the port's tests and in
chip_smoke.py, names one."""

import ast
import importlib
import inspect
import os
import tempfile

import numpy as np
import pytest
import torch

import scythe_tpu_torch as tx
from scythe_tpu_torch import convert, io as sio
from scythe_tpu_torch import model as tmodel
from scythe_tpu_torch import adjoint, balance
from scythe_tpu_torch import timeintegration as tti
from scythe_tpu_torch.examples import assimilate_4dvar, assimilate_enkf
from scythe_tpu_torch.examples import cha_bell_initialization as cb
from scythe_tpu_torch.examples import jw06_baroclinic_slz
from scythe_tpu_torch.physics import reference_state as trs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ENTRY_POINTS = {
    "create_grid": tx.create_grid,
    "initialize": tmodel.initialize,
    "model.integrate_model": tmodel.integrate_model,
    "integrate_model": tx.integrate_model,
    "io.load_checkpoint": sio.load_checkpoint,
    "convert.state_from_numpy": convert.state_from_numpy,
    "convert.load_jax_checkpoint": convert.load_jax_checkpoint,
    "convert.context_extras_from_numpy": convert.context_extras_from_numpy,
    "convert.reference_state_from_numpy": convert.reference_state_from_numpy,
    "examples.cha_bell_initialization.initialize_wave2": cb.initialize_wave2,
    "model.integrate_ensemble": tmodel.integrate_ensemble,
    "adjoint.make_simulator": adjoint.make_simulator,
    "make_simulator": tx.make_simulator,
    "balance.balance_zonal_state": balance.balance_zonal_state,
    "examples.jw06_baroclinic_slz.balanced_delta": jw06_baroclinic_slz.balanced_delta,
    "examples.assimilate_4dvar.build_case": assimilate_4dvar.build_case,
    "examples.assimilate_enkf.build_case": assimilate_enkf.build_case,
}


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_defaults_to_the_card(name):
    param = inspect.signature(ENTRY_POINTS[name]).parameters["device"]
    assert param.default == "cuda"


@pytest.mark.parametrize("fn", [tti.build_semiimplicit_ops, trs.interpolate_reference_file,
                                trs.exact_reference_state, trs.empty_reference_state])
def test_operator_helpers_take_the_device_from_their_caller(fn):
    assert inspect.signature(fn).parameters["device"].default is inspect.Parameter.empty


def _small_model(tmp):
    gp = tx.GridParameters(
        geometry="RLZ", xmin=0.0, xmax=8000.0, num_cells=4, lDim=8,
        zmin=0.0, zmax=8000.0, zDim=8,
        BCL={"u": tx.BC.R1T0, "v": tx.BC.R1T0, "w": tx.BC.R1T1},
        BCR={"u": tx.BC.R1T0, "v": tx.BC.R0},
        vars=("s", "xi", "mu", "u", "v", "w", "mu_c", "mu_r", "qss"),
    )
    with open(os.path.join(tmp, "snd.txt"), "w") as f:
        f.write("1015.0 300.0 14.0\n")
        for z in np.linspace(300.0, 12000.0, 20):
            f.write(f"{z} {300.0 + 0.004 * z} {14.0 * np.exp(-z / 2500.0)}\n")
    pts = tx.create_grid(gp, torch.float64, device="cpu").gridpoints()
    cols = np.zeros((len(pts), 12))
    cols[:, :3] = pts
    np.savetxt(os.path.join(tmp, "ics.csv"), cols, delimiter=",", comments="",
               header="r,l,z," + ",".join(gp.vars))
    return tx.ModelParameters(
        ts=0.25, integration_time=0.25, output_interval=0.25,
        equation_set="MoistEulerRLZ", initial_conditions=os.path.join(tmp, "ics.csv"),
        output_dir=os.path.join(tmp, "out"), ref_state_file=os.path.join(tmp, "snd.txt"),
        grid_params=gp, physical_params={"K": 10.0, "f": 5e-5},
        options={"semiimplicit": True},
    )


def _calls_without_device(tmp):
    """Each entry point called with no device; returns what it made."""
    model = _small_model(tmp)
    _, _, state = tmodel.initialize(model, torch.float64, device="cpu")
    ckpt = os.path.join(tmp, "ckpt.npz")
    sio.save_checkpoint(ckpt, state, 0.0)
    arrays = convert.state_to_numpy(state)
    phys = sio.read_physical_grid(model.initial_conditions, tx.create_grid(
        model.grid_params, torch.float64, device="cpu"))
    ref = tmodel.build_context(
        model, tx.create_grid(model.grid_params, torch.float64, device="cpu"), torch.float64
    ).ref_state
    return {
        "create_grid": lambda: tx.create_grid(model.grid_params, torch.float64).synth_r,
        "initialize": lambda: tmodel.initialize(model, torch.float64)[2].spec,
        "integrate_model": lambda: tx.integrate_model(model, torch.float64)[0].synth_r,
        "io.load_checkpoint": lambda: sio.load_checkpoint(ckpt)[0].spec,
        "convert.state_from_numpy": lambda: convert.state_from_numpy(arrays).spec,
        "convert.load_jax_checkpoint": lambda: convert.load_jax_checkpoint(ckpt)[0].spec,
        "convert.context_extras_from_numpy":
            lambda: convert.context_extras_from_numpy({"sponge_ref": arrays["spec"]})[
                "sponge_ref"],
        "convert.reference_state_from_numpy":
            lambda: convert.reference_state_from_numpy(
                {k: getattr(ref, k).numpy() for k in ref._fields}).sbar,
        "examples.cha_bell_initialization.initialize_wave2":
            lambda: tx.create_grid(
                cb.initialize_wave2(tmp, quick=True, grid_params=cb.cha_bell_grid(4, 8))
                .grid_params, torch.float32).synth_r,
        "model.integrate_ensemble":
            lambda: tmodel.integrate_ensemble(model, phys[None], torch.float64)[0].synth_r,
        "make_simulator": lambda: tx.make_simulator(model, torch.float64)[1].synth_r,
        "examples.assimilate_4dvar.build_case":
            lambda: assimilate_4dvar.build_case(4, 8)[3],
    }


def test_a_call_without_device_runs_on_the_card_or_raises():
    with tempfile.TemporaryDirectory() as tmp:
        calls = _calls_without_device(tmp)
        card = torch.cuda.is_available()
        for name, call in calls.items():
            if card:
                assert call().device.type == "cuda", name
            else:
                with pytest.raises(RuntimeError, match="device='cpu'"):
                    call()


# ---- every call of the port that takes a device names one


def _port_aliases(tree):
    """name -> the port module it is bound to by the file's imports."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith("scythe_tpu_torch"):
                    out[a.asname or a.name] = a.name
        elif isinstance(node, ast.ImportFrom) and (node.module or "").startswith(
                "scythe_tpu_torch"):
            for a in node.names:
                full = f"{node.module}.{a.name}"
                try:
                    importlib.import_module(full)
                except ImportError:
                    continue  # a function or class, not a module
                out[a.asname or a.name] = full
    return out


def _calls_missing_device(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    aliases = _port_aliases(tree)
    missing = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in aliases):
            continue
        fn = getattr(importlib.import_module(aliases[node.func.value.id]),
                     node.func.attr, None)
        if not callable(fn) or inspect.isclass(fn):
            continue
        try:
            params = inspect.signature(fn).parameters
        except (TypeError, ValueError):
            continue
        if "device" not in params:
            continue
        if any(k.arg == "device" for k in node.keywords):
            continue
        names = [n for n, p in params.items()
                 if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
        starred = any(isinstance(a, ast.Starred) for a in node.args)
        positional = ("device" in names and not starred
                      and names.index("device") < len(node.args))
        if not positional:
            missing.append(f"{os.path.basename(path)}:{node.lineno} "
                           f"{node.func.value.id}.{node.func.attr}")
    return missing


# every port test file but this one, whose calls leave the device out on
# purpose, and the card's smoke test
CALLERS = sorted(
    [os.path.join(REPO, "tests", n) for n in os.listdir(os.path.join(REPO, "tests"))
     if n.startswith("test_torch_") and n.endswith(".py") and n != "test_torch_device.py"]
    + [os.path.join(REPO, "chip_smoke.py")]
)


@pytest.mark.parametrize("path", CALLERS, ids=os.path.basename)
def test_every_call_names_its_device(path):
    assert _calls_missing_device(path) == []


def test_the_call_check_finds_a_call_without_device(tmp_path):
    src = tmp_path / "caller.py"
    src.write_text(
        "import scythe_tpu_torch as tx\n"
        "from scythe_tpu_torch import timeintegration as tti\n"
        "tx.create_grid(gp)\n"
        "tx.create_grid(gp, None, 'auto', 'cpu')\n"
        "tx.create_grid(*args)\n"
        "tti.build_semiimplicit_ops(8, 0.0, 1.0, None, 1.0, 0.1, dt, device='cpu')\n"
    )
    assert _calls_missing_device(str(src)) == ["caller.py:3 tx.create_grid",
                                               "caller.py:5 tx.create_grid"]
