"""The port's thermodynamics, microphysics (the Newton saturation adjustment
included) and reference states against scythe_tpu's, float64 on the CPU, on
inputs in the physical range (exactly dry points included), within 1e-12 of
max|ref|."""

from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scythe_tpu.equations.common import EqContext as JCtx
from scythe_tpu.physics import microphysics as jmp
from scythe_tpu.physics import reference_state as jrs
from scythe_tpu.physics import thermodynamics as jtd
from scythe_tpu_torch.equations.common import EqContext as TCtx
from scythe_tpu_torch.physics import microphysics as tmp_
from scythe_tpu_torch.physics import reference_state as trs
from scythe_tpu_torch.physics import thermodynamics as ttd

torch.set_num_threads(2)

REL = 1e-12
N = 2000


@pytest.fixture(scope="module")
def state():
    rng = np.random.default_rng(11)
    q_v = rng.uniform(0.0, 0.02, N)
    q_v[::17] = 0.0  # exactly dry points take the guarded branches
    q_c = rng.uniform(0.0, 2e-3, N)
    q_r = rng.uniform(0.0, 3e-3, N)
    q_r[::5] = 0.0
    return dict(
        Tk=rng.uniform(200.0, 310.0, N),
        rho_d=rng.uniform(0.3, 1.3, N),
        p=rng.uniform(200.0, 1050.0, N),
        q_v=q_v,
        q_c=q_c,
        q_r=q_r,
        q_l=q_c + q_r,
        qss=rng.normal(0.0, 1e-4, N),
        s=rng.uniform(-60.0, 120.0, N),
        xi=rng.uniform(-1.0, 0.1, N),
        mu=np.asarray(jtd.bhyp(q_v)) + rng.normal(0.0, 1e-9, N),
        q_cond=rng.normal(0.0, 1e-5, N),
        rate=rng.uniform(0.0, 20.0, N),
        e=rng.uniform(0.05, 40.0, N),
        q_v_pos=rng.uniform(1e-6, 0.02, N),
        mu_l=np.abs(rng.normal(0.0, 1e-3, N)),
    )


THERMO = {
    "L_v": ("Tk",),
    "vapor_pressure": ("p", "q_v"),
    "entropy": ("Tk", "rho_d", "q_v"),
    "temperature": ("s", "rho_d", "q_v"),
    "sat_pressure_liquid_buck": ("Tk", "p"),
    "sat_pressure_liquid_buck_dT": ("Tk", "p"),
    "q_sat_liquid": ("Tk", "p"),
    "bhyp": ("q_v",),
    "ahyp": ("mu",),
    "dmudq": ("mu", "q_v"),
    "dmudq_source": ("mu", "q_v"),
    "dry_density": ("xi",),
    "log_dry_density": ("rho_d",),
    "P_s": ("Tk", "rho_d", "q_v"),
    "P_xi": ("Tk", "rho_d", "q_v"),
    "P_qv": ("Tk", "rho_d", "q_v"),
    "P_xi_from_s": ("s", "xi", "mu"),
    "pressure_gradient_coeffs": ("Tk", "rho_d", "q_v"),
    "thermodynamic_tuple": ("s", "xi", "mu"),
    "sat_pressure_liquid": ("Tk",),
    "sat_pressure_ice": ("Tk",),
    "mixing_ratio": ("p", "e"),
    "dewpoint": ("p", "q_v_pos"),
    "vapor_entropy": ("Tk", "rho_d", "q_v"),
    "pressure": ("s", "rho_d", "q_v"),
    "sat_pressure_ice_buck": ("Tk", "p"),
    "q_sat_ice": ("Tk", "p"),
    "P_mu": ("Tk", "rho_d", "mu"),
    "potential_temperature": ("s", "xi", "mu"),
    "reversible_theta_e": ("s", "xi", "mu"),
    "theta_rho": ("s", "xi", "mu"),
}

MICRO = {
    "Q_s_factor": ("Tk", "p", "q_v", "q_l"),
    "dqsdp": ("Tk", "p", "rho_d", "q_v", "q_l"),
    "s_condensation": ("q_cond", "Tk", "rho_d", "q_v", "q_l", "p"),
    "vapor_diffusity": ("Tk", "p"),
    "autoconversion": ("q_c", "rho_d"),
    "f_ice": ("Tk",),
    "collection": ("q_c", "q_r", "rho_d", "Tk"),
    "rain_evaporation": ("q_r", "rho_d", "Tk", "p"),
    "f_ventilation": ("q_r", "rho_d", "Tk"),
    "sedimentation": ("q_r", "rho_d", "Tk"),
    "sedimentation_active": ("q_r", "rho_d", "Tk"),
    "sedimentation_formula": ("q_r", "rho_d", "Tk"),
    "linear_saturation_adjustment": ("qss", "Tk", "p", "q_v", "q_l"),
}


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= REL * np.abs(ref).max(), (what, err)


def _call_both(jmod, tmod, name, args, state):
    ref = getattr(jmod, name)(*(jnp.asarray(state[a]) for a in args))
    got = getattr(tmod, name)(*(torch.from_numpy(state[a]) for a in args))
    if isinstance(ref, tuple):
        assert len(got) == len(ref)
        for i, (g, r) in enumerate(zip(got, ref)):
            _close(g.numpy(), r, f"{name}[{i}]")
    else:
        _close(got.numpy(), ref, name)


@pytest.mark.parametrize("name", sorted(THERMO))
def test_thermodynamics_match(state, name):
    _call_both(jtd, ttd, name, THERMO[name], state)


@pytest.mark.parametrize("name", sorted(MICRO))
def test_microphysics_rates_match(state, name):
    _call_both(jmp, tmp_, name, MICRO[name], state)


def test_condensation_rates_match(state):
    st = state
    for invtau in (None, st["rate"]):
        ref = jmp.q_condensation(
            *(jnp.asarray(st[k]) for k in ("qss", "Tk", "p", "q_v", "q_l")),
            100.0, 10.0,
            invtau=None if invtau is None else jnp.asarray(invtau),
        )
        got = tmp_.q_condensation(
            *(torch.from_numpy(st[k]) for k in ("qss", "Tk", "p", "q_v", "q_l")),
            100.0, 10.0,
            invtau=None if invtau is None else torch.from_numpy(invtau),
        )
        _close(got.numpy(), ref, "q_condensation")
    _close(
        tmp_.invtau_condensation(torch.from_numpy(st["Tk"]), torch.from_numpy(st["p"]),
                                 100.0, 10.0).numpy(),
        jmp.invtau_condensation(jnp.asarray(st["Tk"]), jnp.asarray(st["p"]), 100.0, 10.0),
        "invtau_condensation",
    )


@pytest.mark.parametrize("name", ["reversible_theta_e", "theta_rho"])
def test_moist_potential_temperatures_with_liquid_match(state, name):
    _call_both(jtd, ttd, name, ("s", "xi", "mu", "mu_l"), state)


def test_saturation_adjustment_matches(state):
    """The Newton iteration (nine passes, a converged point frozen) on
    consistent states: s from entropy(Tk, rho_d, q_v), so the points lie
    around saturation, warm and cold; the exactly dry ones return zero."""
    st = dict(state)
    st["s"] = np.array(jtd.entropy(*(jnp.asarray(state[k]) for k in ("Tk", "rho_d", "q_v"))))
    st["xi"] = np.log(state["rho_d"] / jtd.rho_d0)
    st["mu"] = np.array(jtd.bhyp(jnp.asarray(state["q_v"])))
    _call_both(jmp, tmp_, "saturation_adjustment", ("s", "xi", "mu", "mu_l"), st)
    dq, dT = tmp_.saturation_adjustment(*(torch.from_numpy(st[k])
                                          for k in ("s", "xi", "mu", "mu_l")))
    assert torch.isfinite(dq).all() and float(dq.abs().max()) > 1e-5
    assert (dq[::17] == 0).all() and (dT[::17] == 0).all()
    assert (dq > 0).any() and (dq < 0).any()  # evaporation and condensation


def test_empty_reference_state_matches():
    ref = jrs.empty_reference_state(5, jnp.float64)
    got = trs.empty_reference_state(5, torch.float64, device="cpu")
    for name in jrs.ReferenceState._fields:
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))


@pytest.fixture(scope="module")
def sounding(tmp_path_factory):
    path = tmp_path_factory.mktemp("physics") / "sounding.txt"
    zs = np.linspace(0.0, 12000.0, 40)
    theta = 300.0 + 0.004 * zs
    qv = 14.0 * np.exp(-zs / 2500.0)
    with open(path, "w") as f:
        f.write(f"1015.0 {theta[0]} {qv[0]}\n")
        for z, th, q in zip(zs[1:], theta[1:], qv[1:]):
            f.write(f"{z} {th} {q}\n")
    return str(path)


def _close_ref_states(got, ref):
    for name in jrs.ReferenceState._fields:
        _close(getattr(got, name).numpy(), getattr(ref, name), name)


@pytest.mark.parametrize("nz", [16, 24, 48])
def test_interpolate_reference_file_matches(sounding, nz):
    args = (sounding, 0.0, 10000.0, nz, (2 * nz - 1) // 3 + 1)
    ref = jrs.interpolate_reference_file(*args, jnp.float64)
    got = trs.interpolate_reference_file(*args, torch.float64, device="cpu")
    _close_ref_states(got, ref)


def test_exact_reference_state_matches(sounding, tmp_path):
    nz = 16
    base = trs.interpolate_reference_file(sounding, 0.0, 1.0e4, nz, 11, device="cpu")
    from scythe_tpu_torch.basis import chebyshev

    z = chebyshev.gauss_points(nz, 0.0, 1.0e4)
    cols = [z] + [getattr(base, k)[:, 0].numpy() for k in ("sbar", "xibar", "mubar")]
    cols.append(np.full(nz, 1e-4))
    path = tmp_path / "exact.txt"
    np.savetxt(path, np.stack(cols, axis=1), fmt="%.17g")
    args = (str(path), 0.0, 1.0e4, nz, 11)
    _close_ref_states(trs.exact_reference_state(*args, torch.float64, device="cpu"),
                      jrs.exact_reference_state(*args, jnp.float64))


def _contexts(options, ref_j, ref_t):
    names = ("s", "xi", "mu", "u", "v", "w", "mu_c", "mu_r", "qss")
    grid = SimpleNamespace(params=SimpleNamespace(vars=names))
    common = dict(grid=grid, coords={}, params={}, options=options, ts=0.25,
                  var_index=names.index)
    return JCtx(ref_state=ref_j, **common), TCtx(ref_state=ref_t, **common)


@pytest.mark.parametrize(
    "options", [{}, {"condensation": "diagnostic", "condensation_tau": 60.0},
                {"reference_quirks": True}],
    ids=["reference", "diagnostic", "quirks"],
)
def test_condensation_adjustment_matches(sounding, options):
    nz = 16
    args = (sounding, 0.0, 10000.0, nz, 11)
    cj, ct = _contexts(
        options,
        jrs.interpolate_reference_file(*args, jnp.float64),
        trs.interpolate_reference_file(*args, torch.float64, device="cpu"),
    )
    rng = np.random.default_rng(5)
    var = np.zeros((9, 6, 4, nz))
    var[0] = rng.normal(0.0, 3.0, (6, 4, nz))  # warm and cold anomalies
    var[2] = rng.normal(0.0, 2e-3, (6, 4, nz))  # moist and dry anomalies
    var[6] = np.abs(rng.normal(0.0, 1e-3, (6, 4, nz)))
    var[7] = np.abs(rng.normal(0.0, 1e-3, (6, 4, nz)))
    var[8] = rng.normal(0.0, 1e-4, (6, 4, nz))
    ref = np.asarray(jmp.condensation_adjustment(jnp.asarray(var), None, cj))
    got = tmp_.condensation_adjustment(torch.from_numpy(var.copy()), None, ct).numpy()
    for v in range(9):
        scale = np.abs(ref[v]).max()
        assert np.abs(got[v] - ref[v]).max() <= REL * max(scale, 1e-300), v
    assert not np.array_equal(got[2], var[2])  # the adjustment did act


def test_context_hooks_match(state):
    rs = SimpleNamespace(Pxi_bar=jnp.asarray(9.0e4), Pxi_prof=None)
    for options in ({}, {"stiff_relaxation": "exp"}, {"condensation_rate_cap": 1e-5}):
        cj, ct = _contexts(options, rs, SimpleNamespace(Pxi_bar=torch.tensor(9.0e4)))
        _close(ct.stiff_rate(torch.from_numpy(state["rate"])).numpy(),
               cj.stiff_rate(jnp.asarray(state["rate"])), "stiff_rate")
        _close(ct.cap_condensation(torch.from_numpy(state["q_cond"])).numpy(),
               cj.cap_condensation(jnp.asarray(state["q_cond"])), "cap_condensation")
        _close(ct.dmudq_source(*(torch.from_numpy(state[k]) for k in ("mu", "q_v"))),
               cj.dmudq_source(*(jnp.asarray(state[k]) for k in ("mu", "q_v"))),
               "dmudq_source")
        assert float(ct.pxi_si()) == float(cj.pxi_si())
