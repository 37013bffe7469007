"""The condensation adjustment's dispatch and its one source of scalars, on
the CPU: ``microphysics.condensation_params`` gives today's formulas for
every option variant; a CPU tensor, a tensor that requires grad and a call
under ``torch.func`` take the plain chain and leave the kernel's ``trace``
counters as they were; a card tensor takes the kernel, in place or through
``CondensationFn``;
the Function's backward, jvp and vmap rules against the plain chain's own
(its forward on the CPU is the plain chain); the wrapper refuses what the
kernel does not take; and the plain chain of each variant against the JAX
package at float64.  The kernel itself is held against the plain chain on
the card (``tests/test_torch_condensation_cuda.py``)."""

import math
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scythe_tpu.equations.common import EqContext as JCtx
from scythe_tpu.physics import microphysics as jmp
from scythe_tpu.physics import reference_state as jrs
from scythe_tpu_torch import device, trace
from scythe_tpu_torch.equations.common import EqContext as TCtx
from scythe_tpu_torch.ops import condensation as cond_ops
from scythe_tpu_torch.physics import microphysics as tmp_
from scythe_tpu_torch.physics import reference_state as trs
from scythe_tpu_torch.physics import thermodynamics as ttd

torch.set_num_threads(2)

REL = 1e-12
NZ = 16
RAIN = ("s", "xi", "mu", "u", "v", "w", "mu_c", "mu_r", "qss")
NO_RAIN = ("s", "xi", "mu", "u", "w", "mu_l", "qss")  # BF02_test's rows
TS = 2.0

# (variables, options, the Params fields the options give)
VARIANTS = {
    "default": (RAIN, {}, dict(diagnostic=False, tau_r=0.25, cap=math.inf,
                               tau_factor=None, quirks=False)),
    "diagnostic": (RAIN, {"condensation": "diagnostic"},
                   dict(diagnostic=True, tau_r=1.0, cap=2.0e-4 * TS, tau_factor=None,
                        quirks=False)),
    "diagnostic_tau": (RAIN, {"condensation": "diagnostic", "condensation_tau": 30.0,
                              "condensation_rate_cap": 3.0e-4},
                       dict(diagnostic=True, tau_r=1.0, cap=3.0e-4 * TS,
                            tau_factor=1.0 - float(np.exp(-TS / 30.0)), quirks=False)),
    "quirks": (RAIN, {"reference_quirks": True},
               dict(diagnostic=False, tau_r=0.25, cap=math.inf, tau_factor=None,
                    quirks=True)),
    "mu_l_no_mu_r": (NO_RAIN, {}, dict(diagnostic=False, tau_r=0.25, cap=math.inf,
                                       tau_factor=None, quirks=False)),
}


@pytest.fixture(scope="module")
def sounding(tmp_path_factory):
    path = tmp_path_factory.mktemp("condensation") / "sounding.txt"
    zs = np.linspace(0.0, 12000.0, 40)
    theta = 300.0 + 0.004 * zs
    qv = 14.0 * np.exp(-zs / 2500.0)
    with open(path, "w") as f:
        f.write(f"1015.0 {theta[0]} {qv[0]}\n")
        for z, th, q in zip(zs[1:], theta[1:], qv[1:]):
            f.write(f"{z} {th} {q}\n")
    return str(path)


@pytest.fixture(scope="module")
def ref_states(sounding):
    args = (sounding, 0.0, 10000.0, NZ, 11)
    return (jrs.interpolate_reference_file(*args, jnp.float64),
            trs.interpolate_reference_file(*args, torch.float64, device="cpu"))


def _contexts(names, options, ref_j, ref_t):
    grid = SimpleNamespace(params=SimpleNamespace(vars=names))
    common = dict(grid=grid, coords={}, params={}, options=options, ts=TS,
                  var_index=names.index)
    return JCtx(ref_state=ref_j, **common), TCtx(ref_state=ref_t, **common)


def _state(names, seed=5):
    """Warm and cold, moist and dry anomalies, cloud, rain and qss, with a
    few points at the guards: no vapour at all, negative cloud."""
    rng = np.random.default_rng(seed)
    shape = (6, 4, NZ)
    var = np.zeros((len(names),) + shape)
    var[names.index("s")] = rng.normal(0.0, 3.0, shape)
    var[names.index("mu")] = rng.normal(0.0, 2e-3, shape)
    cloud = "mu_c" if "mu_c" in names else "mu_l"
    var[names.index(cloud)] = np.abs(rng.normal(0.0, 1e-3, shape))
    var[names.index(cloud), 0, 0] = -1e-3
    if "mu_r" in names:
        var[names.index("mu_r")] = np.abs(rng.normal(0.0, 1e-3, shape))
    var[names.index("qss")] = rng.normal(0.0, 1e-4, shape)
    var[names.index("mu"), 1, 1] = -30.0  # total mu < 0: q_v = 0
    return var


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_params_give_todays_formulas(variant, ref_states):
    names, options, want = VARIANTS[variant]
    _, ct = _contexts(names, options, *ref_states)
    prm = tmp_.condensation_params(ct)
    for key, value in want.items():
        got = getattr(prm, key)
        assert got == value or (isinstance(value, float) and got == pytest.approx(
            value, rel=1e-15, abs=0.0)), (key, got, value)
    rows = dict(s=names.index("s"), xi=names.index("xi"), mu=names.index("mu"),
                cloud=names.index("mu_c" if "mu_c" in names else "mu_l"),
                mu_r=names.index("mu_r") if "mu_r" in names else None,
                qss=names.index("qss"))
    assert {k: getattr(prm, k) for k in rows} == rows
    # the quirks flag picks the Jacobian the context's hook picks
    q = torch.tensor([1e-3, 5e-3, 0.0], dtype=torch.float64)
    m = torch.tensor([2e-3, -1e-3, 1e-2], dtype=torch.float64)
    hook = ct.dmudq_source(m, q)
    mine = ttd.dmudq(m, q) if prm.quirks else ttd.dmudq_source(m, q)
    assert torch.equal(hook, mine)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_chain_of_each_variant_matches_jax(variant, ref_states):
    names, options, _ = VARIANTS[variant]
    cj, ct = _contexts(names, options, *ref_states)
    var = _state(names)
    ref = np.asarray(jmp.condensation_adjustment(jnp.asarray(var), None, cj))
    got = tmp_.condensation_adjustment(torch.from_numpy(var.copy()), None, ct).numpy()
    assert np.isfinite(got).all()
    for v in range(len(names)):
        scale = np.abs(ref[v]).max()
        assert np.abs(got[v] - ref[v]).max() <= REL * max(scale, 1e-300), (names[v], variant)
    assert not np.array_equal(got[names.index("mu")], var[names.index("mu")])


def _launched():
    """(kernel launches, plain-chain runs on a card tensor) so far."""
    rec = trace.process()
    return (rec.total("condensation.launches") or 0,
            rec.total("condensation.plain_launches") or 0)


@pytest.fixture
def zero_counts():
    before = _launched()
    yield
    assert _launched() == before


@pytest.mark.parametrize("case", ["cpu", "requires_grad", "vmap", "jvp"])
def test_dispatch_takes_the_plain_chain(case, ref_states, zero_counts):
    _, ct = _contexts(RAIN, {"condensation": "diagnostic", "condensation_tau": 30.0},
                      *ref_states)
    var = torch.from_numpy(_state(RAIN))
    want = tmp_.condensation_adjustment_plain(var, *_refs(ct), tmp_.condensation_params(ct))
    if case == "cpu":
        got = tmp_.condensation_adjustment(var, None, ct)
        assert got is not var  # out of place
    elif case == "requires_grad":
        leaf = var.clone().requires_grad_(True)
        got = tmp_.condensation_adjustment(leaf, None, ct)
        assert got.grad_fn is not None
        (g,) = torch.autograd.grad(got[0].sum(), leaf)
        assert torch.isfinite(g).all()
        got = got.detach()
    elif case == "vmap":
        got = torch.func.vmap(lambda v: tmp_.condensation_adjustment(v, None, ct))(
            torch.stack([var, var]))[1]
    else:
        got, _ = torch.func.jvp(lambda v: tmp_.condensation_adjustment(v, None, ct),
                                (var,), (torch.ones_like(var),))
    scale = want.abs().amax(dim=tuple(range(1, want.ndim)), keepdim=True)
    assert ((got - want).abs() <= REL * scale).all()


def _refs(ctx):
    rs = ctx.ref_state
    return rs.sbar, rs.xibar, rs.mubar


class _OnCard:
    """Stands in for a CUDA tensor in the dispatch's decision."""

    is_cuda = True

    def __init__(self, requires_grad=False):
        self.requires_grad = requires_grad


class _CardTensor(torch.Tensor):
    """A CPU tensor that the dispatch takes for a CUDA one."""

    @property
    def is_cuda(self):
        return True


def test_dispatch_decision_on_a_card_tensor(ref_states, monkeypatch):
    """A card tensor takes the kernel: in place where neither autograd nor a
    functorch transform sees the call, through CondensationFn otherwise
    (an input that requires grad with grad on, or inside a transform); the
    plain chain never."""
    _, ct = _contexts(RAIN, {}, *ref_states)
    rs = ct.ref_state
    _, ct_grad = _contexts(RAIN, {}, ref_states[0], SimpleNamespace(
        sbar=rs.sbar, xibar=rs.xibar.clone().requires_grad_(True), mubar=rs.mubar))
    seen = []
    monkeypatch.setattr(cond_ops, "condensation_adjust",
                        lambda v, *a: seen.append("in place") or v)
    monkeypatch.setattr(cond_ops.CondensationFn, "apply", lambda v, *a: seen.append("fn") or v)
    monkeypatch.setattr(tmp_, "condensation_adjustment_plain",
                        lambda v, *a: seen.append("plain") or v)
    for var, c in ((_OnCard(), ct), (_OnCard(requires_grad=True), ct), (_OnCard(), ct_grad)):
        tmp_.condensation_adjustment(var, None, c)
    with torch.no_grad():  # grad off: a tensor that requires grad takes the kernel in place
        tmp_.condensation_adjustment(_OnCard(requires_grad=True), None, ct_grad)
    torch.func.vmap(lambda x: tmp_.condensation_adjustment(_OnCard(), None, ct) and x)(
        torch.zeros(2, 3))
    tmp_.condensation_adjustment(torch.zeros(9, 4, 16), None, ct)
    assert seen == ["in place", "fn", "fn", "in place", "fn", "plain"]
    assert device.traced_reason((_OnCard(True),)) == "an input requires grad"


def _step_layout(var):
    """``var`` [nvars, A, *rest] laid out as the step makes its state:
    [a][variable][rest] in memory."""
    return var.transpose(0, 1).contiguous().transpose(0, 1)


def test_layouts_the_kernel_takes():
    var = torch.from_numpy(_state(RAIN))
    assert cond_ops.takes_layout(var)
    assert cond_ops.takes_layout(_step_layout(var))
    rz = var[:, :, 1].contiguous()  # [nvars, A, z]
    assert cond_ops.takes_layout(rz) and cond_ops.takes_layout(_step_layout(rz))
    z = var[:, 2, 1].contiguous()  # [nvars, z]
    assert cond_ops.takes_layout(z) and cond_ops.takes_layout(_step_layout(z))
    assert cond_ops.takes_layout(var[:, :1].contiguous())  # A = 1
    assert cond_ops.takes_layout(var[:, :, 1])  # gaps between the blocks: at their strides
    assert not cond_ops.takes_layout(var.transpose(1, 2))  # a block not contiguous
    assert not cond_ops.takes_layout(var[:, :, :, ::2])
    assert not cond_ops.takes_layout(var[:1].expand(9, -1, -1, -1))  # rows overlap
    assert not cond_ops.takes_layout(var[:, :1].expand(-1, 6, -1, -1))  # points overlap
    assert not cond_ops.takes_layout(torch.zeros(9))
    assert not cond_ops.takes_layout(torch.zeros(9, 0, 16))


@pytest.mark.parametrize("layout", ["step", "contiguous", "other"])
def test_dispatch_hands_the_kernel_its_inputs(layout, ref_states, monkeypatch, zero_counts):
    """On a card, outside autograd and functorch, the wrapper gets var_np1
    itself, whatever its layout, the three reference columns and the
    context's Params, and its result is returned; a layout the kernel does
    not take raises, and no copy is made."""
    _, ct = _contexts(RAIN, {"reference_quirks": True}, *ref_states)
    var = torch.from_numpy(_state(RAIN))
    var = {"step": _step_layout(var), "contiguous": var,
           "other": var.transpose(2, 3).contiguous().transpose(2, 3)}[layout]
    var = var.as_subclass(_CardTensor)
    if layout == "other":
        with pytest.raises(ValueError, match="block contiguous"):
            tmp_.condensation_adjustment(var, None, ct)
        return
    calls = []
    monkeypatch.setattr(cond_ops, "condensation_adjust",
                        lambda *a: calls.append(a) or a[0])
    out = tmp_.condensation_adjustment(var, None, ct)
    ((v, sbar, xibar, mubar, prm),) = calls
    assert out is var and v is var and prm == tmp_.condensation_params(ct)
    rs = ct.ref_state
    assert sbar is rs.sbar and xibar is rs.xibar and mubar is rs.mubar


def _rel(got, want):
    """max |got - want| of each row over the row's max |want|."""
    return float(((got - want).abs().flatten(1).amax(1)
                  / want.abs().flatten(1).amax(1).clamp_min(1e-300)).max())


@pytest.mark.parametrize("rule", ["forward", "backward", "jvp", "vmap", "vmap_axis1",
                                  "vmap_of_grad", "batched_refs"])
def test_condensation_fn_rules_match_the_plain_chains(rule, ref_states, zero_counts):
    """CondensationFn's rules on the CPU, where its forward is the plain
    chain, against autograd and torch.func through the plain chain itself:
    the same formulas the card runs around the kernel."""
    _, ct = _contexts(RAIN, {"condensation": "diagnostic", "condensation_tau": 30.0},
                      *ref_states)
    prm = tmp_.condensation_params(ct)
    sbar, xibar, mubar = _refs(ct)
    var = torch.from_numpy(_state(RAIN))
    plain = tmp_.condensation_adjustment_plain
    fn = cond_ops.CondensationFn.apply
    rng = torch.Generator().manual_seed(3)
    if rule == "forward":
        got = fn(var, sbar, xibar, mubar, prm)
        assert got is not var and _rel(got, plain(var, sbar, xibar, mubar, prm)) <= REL
    elif rule == "backward":
        g = torch.randn(var.shape, dtype=var.dtype, generator=rng)
        grads = []
        for f in (fn, plain):
            v, x = var.clone().requires_grad_(True), xibar.clone().requires_grad_(True)
            grads.append(torch.autograd.grad(f(v, sbar, x, mubar, prm), (v, x), g))
        for got, want in zip(*grads):
            assert torch.isfinite(got).all() and _rel(got, want) <= REL
    elif rule == "jvp":
        tv = torch.randn(var.shape, dtype=var.dtype, generator=rng)
        tx = torch.randn(xibar.shape, dtype=var.dtype, generator=rng)
        got, want = (torch.func.jvp(lambda v, x: f(v, sbar, x, mubar, prm), (var, xibar),
                                    (tv, tx)) for f in (fn, plain))
        assert _rel(got[0], want[0]) <= REL and _rel(got[1], want[1]) <= REL
    elif rule in ("vmap", "vmap_axis1"):
        members = torch.stack([torch.from_numpy(_state(RAIN, seed)) for seed in (5, 6, 7)])
        d = 0 if rule == "vmap" else 1
        got = torch.func.vmap(lambda v: fn(v, sbar, xibar, mubar, prm), in_dims=d)(
            members.movedim(0, d))
        for i in range(3):
            assert _rel(got[i], plain(members[i], sbar, xibar, mubar, prm)) <= REL
    elif rule == "vmap_of_grad":
        members = torch.stack([torch.from_numpy(_state(RAIN, seed)) for seed in (5, 6)])
        got, want = (torch.func.vmap(torch.func.grad(
            lambda v: (f(v, sbar, xibar, mubar, prm) ** 2).sum()))(members)
            for f in (fn, plain))
        assert _rel(got.flatten(0, 1), want.flatten(0, 1)) <= REL
    else:
        with pytest.raises(NotImplementedError, match="one reference state"):
            torch.func.vmap(lambda v, s: fn(v, s, xibar, mubar, prm))(
                torch.stack([var, var]), torch.stack([sbar, sbar]))


def test_wrapper_refuses_what_the_kernel_does_not_take(ref_states, zero_counts):
    _, ct = _contexts(RAIN, {}, *ref_states)
    prm = tmp_.condensation_params(ct)
    rs = ct.ref_state
    refs = (rs.sbar, rs.xibar, rs.mubar)
    var = torch.from_numpy(_state(RAIN))
    bad = [
        ((var.to(torch.float16), *refs, prm), "float32 or float64"),
        ((var[0], *refs, prm), "rows"),
        ((var.transpose(1, 2), *refs, prm), "block contiguous"),
        ((var[..., :8].contiguous(), *refs, prm), "nz = 8"),
        ((var.float(), *refs, prm), "sbar is torch.float64"),
        ((var, rs.sbar.t(), rs.xibar, rs.mubar, prm), "sbar must be"),
        ((var, *refs, tmp_.condensation_params(
            _contexts(RAIN[:8] + ("mu_x", "qss"), {}, *ref_states)[1])), "rows"),
        ((var, *refs, prm), "runs on a CUDA tensor"),
        ((_step_layout(var), *refs, prm), "runs on a CUDA tensor"),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            cond_ops.condensation_adjust(*args)


def test_counters_are_read_by_the_graphs_and_the_trace(ref_states):
    """The plain chain's runs on a card tensor are the ``trace`` counter
    ``condensation.plain_launches``: added at once, and held on the capture
    inside ``trace.capturing`` (what ``graphs.CapturedStep`` adds a replay)."""
    _, ct = _contexts(RAIN, {}, *ref_states)
    var = torch.from_numpy(_state(RAIN)).as_subclass(_CardTensor)
    args = (var, *_refs(ct), tmp_.condensation_params(ct))
    n0, p0 = _launched()
    cond_ops._plain(*args)
    assert _launched() == (n0, p0 + 1)
    with trace.capturing(None, "cpu") as cap:
        cond_ops._plain(*args)
        cond_ops._plain(*args)
    assert cap.counts == {"condensation.plain_launches": 2}
    assert _launched() == (n0, p0 + 1)
