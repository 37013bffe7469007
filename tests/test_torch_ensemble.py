"""Ensembles on the port: scythe_tpu_torch.model.integrate_ensemble against
scythe_tpu.model.integrate_ensemble.

Members run as a leading axis (torch.func.vmap over a member's run); both
kernels' vmap rules fold the members into one call a step (on the card,
one launch).  Float64 on the CPU, the same numpy ICs through both packages:
members within 1e-12 of each field's max|ref| of the JAX ensemble and of
their own single runs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import scythe_tpu as jx
from scythe_tpu.model import integrate_ensemble as jensemble

import scythe_tpu_torch as tx
from scythe_tpu_torch import model as tmodel
from scythe_tpu_torch.examples import cha_bell_initialization as cb
from scythe_tpu_torch.ops import column_solve, rlz_analysis
from scythe_tpu_torch.parallel.mesh import make_ensemble_mesh

torch.set_num_threads(2)
F64 = torch.float64
VARS = ("s", "xi", "mu", "u", "v", "w", "mu_c", "mu_r", "qss")


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def _grid_params(pkg):
    return pkg.GridParameters(
        geometry="RLZ", xmin=0.0, xmax=10000.0, num_cells=4, lDim=8, zmin=0.0,
        zmax=10000.0, zDim=12, BCL={"u": pkg.BC.R1T0, "v": pkg.BC.R1T0, "w": pkg.BC.R1T1},
        BCR={"u": pkg.BC.R1T0, "v": pkg.BC.R0}, vars=VARS,
    )


@pytest.fixture(scope="module")
def sounding(tmp_path_factory):
    p = tmp_path_factory.mktemp("ensemble") / "sounding.txt"
    zs = np.linspace(0.0, 12000.0, 40)
    with open(p, "w") as f:
        f.write("1015.0 300.0 14.0\n")
        for z in zs[1:]:
            f.write(f"{z} {300.0 + 0.004 * z} {14.0 * np.exp(-z / 2500.0)}\n")
    return str(p)


def _model(pkg, sounding, n_steps, options=None):
    return pkg.ModelParameters(
        ts=0.25, integration_time=n_steps * 0.25, output_interval=n_steps * 0.25,
        equation_set="MoistEulerRLZ", initial_conditions="unused.csv",
        output_dir="unused_out", ref_state_file=sounding, grid_params=_grid_params(pkg),
        physical_params={"K": 10.0, "f": 5.0e-5},
        options={"semiimplicit": True, **(options or {})},
    )


def _bubbles(n_members):
    """Warm bubbles of growing amplitude, each shifted off-axis."""
    grid = tx.create_grid(_grid_params(tx), F64, device="cpu")
    pts = grid.gridpoints()
    r, lam, z = pts[:, 0], pts[:, 1], pts[:, 2]
    ics = np.zeros((n_members, 9) + grid.spatial_shape)
    for m in range(n_members):
        rad = np.sqrt(((r * np.cos(lam) - 3000.0 - 500.0 * m) / 1500.0) ** 2
                      + (r * np.sin(lam) / 1500.0) ** 2 + ((z - 2000.0) / 1500.0) ** 2)
        cos2 = np.maximum(0.0, np.cos(np.pi * np.minimum(rad, 1.0) / 2.0)) ** 2
        ics[m, 0] = ((2.0 + m) * cos2).reshape(grid.spatial_shape)
    return ics


@pytest.mark.parametrize(
    "options",
    [None, {"si_mode": "variable", "implicit_vdiff": True, "smagorinsky": 0.2}],
    ids=["semi-implicit", "variable-si-vdiff-smagorinsky"],
)
def test_ensemble_matches_jax(sounding, options):
    """Three members of the moist RLZ semi-implicit core, 10 steps: every
    step's column solve and analysis run under vmap; within 1e-12 of the JAX
    ensemble."""
    ics = _bubbles(3)
    _, ref = jensemble(_model(jx, sounding, 10, options), ics, dtype=jnp.float64)
    grid, out = tmodel.integrate_ensemble(_model(tx, sounding, 10, options), ics, dtype=F64,
                                          device="cpu")
    assert out.shape == (3, 9) + grid.spatial_shape
    for m in range(3):
        assert _rel(out[m], ref[m]) <= 1e-12, m


def test_kernels_take_every_member_in_one_call(sounding, monkeypatch):
    """Each step calls the column solve once at [members x columns, nz] and
    the analysis once at [members x vars, ...] (on the card: one launch
    each), plus the members' initial analysis."""
    calls = {"solve": [], "analysis": []}
    solve_plain, analysis_plain = (column_solve.apply_column_operator_plain,
                                   rlz_analysis.rlz_analysis_plain)

    def solve_spy(x, w, M):
        calls["solve"].append(tuple(x.shape))
        return solve_plain(x, w, M)

    def analysis_spy(phys, *ops):
        calls["analysis"].append(tuple(phys.shape))
        return analysis_plain(phys, *ops)

    monkeypatch.setattr(column_solve, "apply_column_operator_plain", solve_spy)
    monkeypatch.setattr(rlz_analysis, "rlz_analysis_plain", analysis_spy)
    grid, _ = tmodel.integrate_ensemble(_model(tx, sounding, 5), _bubbles(4), dtype=F64,
                                        device="cpu")
    cols = 4 * int(np.prod(grid.spatial_shape[:2]))
    assert calls["solve"] == [(cols, 12)] * 5
    assert calls["analysis"] == [(4 * 9,) + grid.spatial_shape] * 6


def test_members_equal_their_single_runs():
    """The flagship two-way slab model (RL, no hand-written kernel), three
    members scaled 1 + i/100 as bench.py's ensemble: each member within
    1e-12 of its own run through the same step."""
    model = cb.flagship_model(8, 8)
    grid = tx.create_grid(model.grid_params, F64, device="cpu")
    base = cb.vortex_phys(grid)
    ics = np.stack([base * (1.0 + i / 100.0) for i in range(3)])
    _, out = tmodel.integrate_ensemble(model, ics, dtype=F64, device="cpu")
    step = tmodel.build_step(model, grid, tmodel.build_context(model, grid, F64), F64)
    for i in range(3):
        phys0 = torch.from_numpy(ics[i])
        state = tx.timeintegration.initial_state(
            grid.analysis(phys0), phys0.shape, F64)
        single = grid.synthesis(tmodel.make_scan(step, model.num_ts)(state).spec)["val"]
        assert _rel(out[i], single.numpy()) <= 1e-12, i


def test_integrate_ensemble_api():
    """tests/test_jax_native.py::test_integrate_ensemble_api on the port:
    shapes, finite values, and the periodic advection's shift invariance;
    and the port against the JAX ensemble (1e-12)."""

    def model(pkg):
        gp = pkg.GridParameters(geometry="R", xmin=-50.0, xmax=50.0, num_cells=40,
                                BCL={"u": pkg.BC.PERIODIC}, BCR={"u": pkg.BC.PERIODIC},
                                vars={"u": 1})
        return pkg.ModelParameters(ts=0.1, integration_time=1.0, output_interval=1.0,
                                   equation_set="LinearAdvection1D", grid_params=gp,
                                   physical_params={"c_0": 1.0, "K": 0.05})

    grid = tx.create_grid(model(tx).grid_params, F64, device="cpu")
    r = np.asarray(grid.r_mish)
    shifts = np.array([-5.0, 0.0, 5.0])
    ics = np.exp(-(((r[None, None, :] - shifts[:, None, None]) / 15.0) ** 2))
    grid2, out = tmodel.integrate_ensemble(model(tx), ics, dtype=F64, device="cpu")
    assert out.shape == (3, 1) + grid2.spatial_shape
    assert np.isfinite(out).all()
    assert np.allclose(out.max(axis=-1)[:, 0], out.max(axis=-1)[0, 0], atol=1e-8)
    _, ref = jensemble(model(jx), ics, dtype=jnp.float64)
    assert _rel(out, ref) <= 1e-12


def test_mesh_is_not_ported(sounding):
    """integrate_ensemble(mesh=...) on the moist core: two thread-shards, a
    member each, equal the unsharded ensemble (1e-13 of the max), and a
    member count the mesh does not divide raises."""
    mesh = make_ensemble_mesh(2, device="cpu")
    model = _model(tx, sounding, 2)
    _, ref = tmodel.integrate_ensemble(model, _bubbles(2), dtype=F64, device="cpu")
    _, out = tmodel.integrate_ensemble(model, _bubbles(2), dtype=F64, mesh=mesh,
                                       device="cpu")
    assert _rel(out, ref) <= 1e-13
    with pytest.raises(ValueError, match="divisible"):
        tmodel.integrate_ensemble(model, _bubbles(3), dtype=F64, mesh=mesh, device="cpu")



@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_analysis_plan_takes_folded_members(dtype):
    """The analysis kernel's plan at the folded shapes of this slice: the
    4-member shower [36, 144, 16, 32], 16 members of the JW06 grid
    [144, 144, 96, 24], and a balance Jacobian block of 128 columns
    [1152, 144, 4, 24] (b_rDim 51 in each): it fits and its grid covers
    every variable."""
    for V, R, L, Z, B in ((36, 144, 16, 32, 51), (144, 144, 96, 24, 51),
                          (1152, 144, 4, 24, 51)):
        p = rlz_analysis.plan((V, R, L, Z), B, dtype)
        assert p.smem <= rlz_analysis.SMEM_MAX and p.grid[2] == V, (V, p)
