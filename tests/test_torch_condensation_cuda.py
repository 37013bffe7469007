"""The condensation kernel (``ops/csrc/condensation.cu``) against its plain
chain on the card: at the mature TC's shape (300 x 4 x 24) and JW06's
(144 x 96 x 24), 9 variables, in float32 and float64, in the default and the
diagnostic mode, laid out as the step's state and contiguous; at points on every guard of the chain (no vapour, negative
vapour, cloud and rain, the Buck formula's clamps at both ends, the ratio's
clamp, the vapour and cloud limits on q_cond, the diagnostic cap, the source
Jacobian's clamp and the raw one); through ``CondensationFn`` where
autograd or a functorch transform sees the call (its backward, jvp and vmap
rules against autograd and torch.func through the plain chain); and in a
captured step of the TC.

Every test needs a CUDA card and skips without one.  This file imports no
jax, so a card machine without it runs it alone, without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_condensation_cuda.py
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from scythe_tpu_torch import trace
from scythe_tpu_torch.equations.common import EqContext
from scythe_tpu_torch.examples.tc_intensification_rlz import ZTOP, jordan_sounding
from scythe_tpu_torch.ops import condensation as cond_ops
from scythe_tpu_torch.physics import microphysics as mp
from scythe_tpu_torch.physics import reference_state as trs

pytestmark = pytest.mark.chip

NAMES = ("s", "xi", "mu", "u", "v", "w", "mu_c", "mu_r", "qss")
NZ = 24
SHAPES = {"tc": (300, 4, NZ), "jw06": (144, 96, NZ)}
MODES = {"default": {}, "diagnostic": {"condensation": "diagnostic",
                                       "condensation_rate_cap": 2.0e-4,
                                       "condensation_tau": 30.0}}
OUT_ROWS = ("s", "mu", "mu_c")
SEEDS = {("tc", "default"): 11, ("tc", "diagnostic"): 12, ("jw06", "default"): 21,
         ("jw06", "diagnostic"): 22}
# the kernel against the plain chain in the same type: per output row,
# max|kernel - plain| over max|plain|.  In f32 the two round apart by up to
# ~10 ulps of a row's max on an H100 (FMA contraction, and the plain chain's
# division by a scalar taken as a product by its reciprocal there), which the
# cancellation in q_v - q_sat carries into q_cond
F64_REL = 1e-13
F32_ULPS = 16  # of the row's max, 2**-23 relative each


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


@pytest.fixture(scope="module")
def sounding(tmp_path_factory):
    return jordan_sounding(str(tmp_path_factory.mktemp("cond") / "snd.txt"), 0.9, 20.0)


def _ctx(sounding, options, dtype, names=NAMES):
    rs = trs.interpolate_reference_file(sounding, 0.0, ZTOP, NZ, 16, dtype, device="cuda")
    grid = SimpleNamespace(params=SimpleNamespace(vars=names))
    return EqContext(grid=grid, coords={}, params={}, options=options, ts=2.0,
                     var_index=names.index, ref_state=rs)


def _refs(ctx):
    rs = ctx.ref_state
    return rs.sbar, rs.xibar, rs.mubar


def _physical(spatial, seed):
    """Warm and cold, moist and dry anomalies with cloud, rain and qss, in
    float64 on the host."""
    rng = np.random.default_rng(seed)
    var = np.zeros((len(NAMES),) + spatial)
    var[0] = rng.normal(0.0, 3.0, spatial)
    var[1] = rng.normal(0.0, 0.01, spatial)
    var[2] = rng.normal(0.0, 2e-3, spatial)
    var[3:6] = rng.normal(0.0, 10.0, (3,) + spatial)
    var[6] = np.abs(rng.normal(0.0, 1e-3, spatial))
    var[7] = np.abs(rng.normal(0.0, 1e-3, spatial))
    var[8] = rng.normal(0.0, 1e-4, spatial)
    return var


def _edges(ctx, seed):
    """[9, 16, 4, 24]: each radial row a family of points on one guard."""
    var = _physical((16, 4, NZ), seed)
    mubar = ctx.ref_state.mubar[:, 0].double().cpu().numpy()
    i = NAMES.index
    var[i("mu"), 1] = -mubar - 30.0  # no vapour: q_v = 0, e = 0, the ratio's clamp
    var[i("mu"), 2] = -1.5 * mubar  # total mu < 0
    var[i("mu_c"), 3] = -2e-3  # negative cloud: q_c = 0, dmudq_source's clamp at 2
    var[i("mu"), 3] = 5e-3  # ... where it condenses
    var[i("mu_r"), 4] = -1e-3  # negative rain
    var[i("xi"), 5] = -4.0  # Tk ~ 60 K: the Buck formula's Tc clamp at 100 K
    var[i("xi"), 6] = 2.0  # Tk ~ 650 K: its clamp at 400 K
    var[i("qss"), 7] = -1.0  # q_cond > q_v: min(q_v, .)
    var[i("mu"), 8] = -0.9 * mubar  # dry with cloud: max(-q_c, .)
    var[i("mu"), 9] = 2e-2  # strongly supersaturated: the diagnostic cap
    var[i("mu_c"), 10] = 0.0  # no cloud at all
    var[i("mu_c"), 11] = -1e-6  # cloud just below 0
    var[i("mu"), 12] = 0.0
    var[i("s"), 12] = 0.0  # the reference column itself
    return var


def _launched():
    """(kernel launches, plain-chain runs on the card) so far (``trace``)."""
    rec = trace.process()
    return (rec.total("condensation.launches") or 0,
            rec.total("condensation.plain_launches") or 0)


def _since(start):
    """``_launched()`` less ``start``."""
    return tuple(now - then for now, then in zip(_launched(), start))


def _both(var64, ctx, dtype, layout="step"):
    """(kernel, plain, input) of the same input in ``dtype`` on the card, as
    float64 on the host; the kernel through the dispatch, which must take it
    once and adjust it in place, laid out as the step's state ([a][variable]
    [rest] in memory) or contiguous."""
    var = torch.from_numpy(var64).to(device="cuda", dtype=dtype)
    if layout == "step":
        var = var.transpose(0, 1).contiguous().transpose(0, 1)
    plain = mp.condensation_adjustment_plain(var, *_refs(ctx), mp.condensation_params(ctx))
    work = var.clone()
    assert work.stride() == var.stride() and cond_ops.takes_layout(work)
    start = _launched()
    out = mp.condensation_adjustment(work, None, ctx)
    assert out is work  # in place
    assert _since(start) == (1, 0)
    torch.cuda.synchronize()
    for v, name in enumerate(NAMES):
        if name not in OUT_ROWS:
            assert torch.equal(out[v], var[v]), name
    return tuple(t.double().cpu().numpy() for t in (out, plain, var))


def _row_rel(got, ref):
    """{row: max|got - ref| / max|ref|} of the output rows."""
    out = {}
    for name in OUT_ROWS:
        v = NAMES.index(name)
        out[name] = float(np.abs(got[v] - ref[v]).max() / np.abs(ref[v]).max())
    return out


@pytest.mark.parametrize("layout", ["step", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_matches_the_plain_chain(card, sounding, shape, mode, dtype, layout):
    ctx = _ctx(sounding, MODES[mode], dtype)
    var64 = _physical(SHAPES[shape], seed=SEEDS[shape, mode])
    got, plain, inp = _both(var64, ctx, dtype, layout)
    assert np.isfinite(got).all() and np.isfinite(plain).all()
    rel = _row_rel(got, plain)
    limit = F64_REL if dtype == torch.float64 else F32_ULPS * 2.0**-23
    print(f"{shape} {mode} {dtype} {layout}: kernel vs plain {rel} (limit {limit:.3e})")
    assert max(rel.values()) <= limit, (rel, limit)
    for name in OUT_ROWS:  # the adjustment acted
        v = NAMES.index(name)
        assert not np.array_equal(got[v], inp[v]), name
    if dtype == torch.float32:  # and is as near the float64 chain as the f32 chain
        _no_farther_than_the_plain_chain(got, plain, var64, sounding, MODES[mode])


def _no_farther_than_the_plain_chain(got, plain, var64, sounding, options):
    ctx64 = _ctx(sounding, options, torch.float64)
    exact = mp.condensation_adjustment_plain(
        torch.from_numpy(var64).cuda(), *_refs(ctx64),
        mp.condensation_params(ctx64)).cpu().numpy()
    for name in OUT_ROWS:
        v = NAMES.index(name)
        k_err = np.abs(got[v] - exact[v]).max()
        p_err = np.abs(plain[v] - exact[v]).max()
        floor = F32_ULPS * 2.0**-23 * np.abs(exact[v]).max()
        print(f"  {name}: f32 kernel / chain against the f64 chain {k_err:.3e} / {p_err:.3e}")
        assert k_err <= 2.0 * p_err + floor, (name, k_err, p_err, floor)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("variant", ["default", "diagnostic", "quirks", "diagnostic_quirks"])
def test_kernel_on_every_guard(card, sounding, variant, dtype):
    options = dict(MODES["diagnostic" if "diagnostic" in variant else "default"])
    if "quirks" in variant:
        options["reference_quirks"] = True
    ctx = _ctx(sounding, options, dtype)
    var64 = _edges(ctx, seed=7)
    got, plain, _ = _both(var64, ctx, dtype)
    assert np.array_equal(np.isfinite(got), np.isfinite(plain))
    assert np.isfinite(got[:, 1:3]).all()  # no vapour survives, in f32 too
    if dtype == torch.float64:
        for name in OUT_ROWS:
            v = NAMES.index(name)
            scale = np.maximum(np.maximum(np.abs(plain[v]), np.abs(var64[v])),
                               1e-6 * np.abs(plain[v]).max())
            err = np.abs(got[v] - plain[v]) / scale
            assert err.max() <= 1e-12, (name, float(err.max()),
                                        np.unravel_index(err.argmax(), err.shape))
    else:  # no farther from the float64 chain than the float32 chain is
        _no_farther_than_the_plain_chain(got, plain, var64, sounding, options)


@pytest.mark.parametrize("rule", ["grad", "jvp", "vmap"])
def test_the_function_on_the_card(card, sounding, rule):
    """Where autograd or a functorch transform sees the call, the dispatch
    takes CondensationFn: the kernel once, out of place, on the TC's shape
    in f64 (the input as it was); its backward and jvp the plain chain's,
    run once on the card; its vmap one launch for all members."""
    ctx = _ctx(sounding, MODES["diagnostic"], torch.float64)
    prm, refs = mp.condensation_params(ctx), _refs(ctx)
    var64 = _physical(SHAPES["tc"], seed=31)
    var = torch.from_numpy(var64).cuda().transpose(0, 1).contiguous().transpose(0, 1)
    plain = mp.condensation_adjustment_plain
    adjust = mp.condensation_adjustment
    rng = torch.Generator(device="cuda").manual_seed(4)
    t = torch.randn(var.shape, dtype=var.dtype, device="cuda", generator=rng)
    start = _launched()
    if rule == "grad":
        leaf = var.clone().requires_grad_(True)
        out = adjust(leaf, None, ctx)
        assert out is not leaf and torch.equal(leaf.detach(), var)
        assert _since(start) == (1, 0)
        (got,) = torch.autograd.grad(out, leaf, t)
        assert _since(start)[1] == 1
        leaf2 = var.clone().requires_grad_(True)
        (want,) = torch.autograd.grad(plain(leaf2, *refs, prm), leaf2, t)
        outs = [(out.detach(), plain(var, *refs, prm), F64_REL), (got, want, 1e-12)]
    elif rule == "jvp":
        out, got = torch.func.jvp(lambda v: adjust(v, None, ctx), (var,), (t,))
        assert _since(start) == (1, 1)
        want_out, want = torch.func.jvp(lambda v: plain(v, *refs, prm), (var,), (t,))
        outs = [(out, want_out, F64_REL), (got, want, 1e-12)]
    else:
        members = torch.stack([var, var + 1e-3 * t, var - 1e-3 * t])
        out = torch.func.vmap(lambda v: adjust(v, None, ctx))(members)
        assert _since(start) == (1, 0)
        outs = [(out[i], plain(members[i], *refs, prm), F64_REL) for i in range(3)]
    torch.cuda.synchronize()
    for got, want, limit in outs:
        rel = ((got - want).abs().flatten(1).amax(1) / want.abs().flatten(1).amax(1))
        assert torch.isfinite(got).all() and float(rel.max()) <= limit, (rule, rel, limit)


def test_a_captured_tc_step_launches_the_kernel_once(card, tmp_path):
    from scythe_tpu_torch import model as tmodel
    from scythe_tpu_torch.examples.tc_intensification_rlz import tc_mature_model

    model = tc_mature_model(os.path.join(str(tmp_path), "tc"), t_end=600.0,
                            output_interval=600.0)
    grid, ctx, state = tmodel.initialize(model, torch.float32, "cuda")
    step = tmodel.build_step(model, grid, ctx, torch.float32)
    start = _launched()
    s3 = tmodel.make_scan(step, 2)(state)  # t = 1, 2: eager
    assert _since(start)[0] == 2
    before = trace.process().counters.get("graph.nodes.condensation")
    total0 = before.total if before else 0.0
    g = tmodel.make_scan(step, 5)(s3)  # the warm-up step, the capture, 4 replays
    torch.cuda.synchronize()
    nodes = trace.process().counters["graph.nodes.condensation"].total - total0
    assert nodes == 1, nodes  # the kernel, on the state as the step lays it out
    assert _since(start)[0] == 2 + 5
    tmodel.make_scan(step, 7)(g)  # 7 replays
    torch.cuda.synchronize()
    assert _since(start)[0] == 2 + 5 + 7
    assert _since(start)[1] == 0
    assert torch.isfinite(g.spec).all()
