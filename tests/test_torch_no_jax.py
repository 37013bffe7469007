"""scythe_tpu_torch imports and runs with jax (and the JAX package) blocked:
a fresh interpreter with sys.modules['jax'] = None imports the package (its
kernels' modules and every example included), runs 3 steps of the moist
RLZ core, of the flagship two-way slab model and of Williamson case 2 on the
SL sphere on the CPU, writes NetCDF output, and registers all 21 equation
sets, importing no triton; a compensated grid and a factored one (nl 4096)
build and transform.  It runs 3 steps of integrate_sharded on 2
thread-shards by psum and by halo.  The published-benchmark examples, the
model configs (run from a scratch directory: tc_mature_rlz.py writes its ICs
there), the CLI (``python -m scythe_tpu_torch``'s ``cli`` and ``__main__``)
and the harness entry import too; the CLI runs LinearAdvection1D for 3
steps on 2 thread-shards and graft_entry.entry() one step, on the CPU.  It
differentiates the moist core through
adjoint.make_simulator and runs a two-member integrate_ensemble, and each
kernel wrapper's output carries its Function's grad_fn when its input needs
a gradient (the wrappers once returned outputs with no graph).  The layers
import one way: ``physics/`` and ``ops/`` never import the graph runner, and
``trace.py`` imports nothing of the package."""

import ast
import os
import subprocess
import sys
import textwrap

import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(
    """
    import os, sys, tempfile
    sys.modules["jax"] = None
    sys.modules["scythe_tpu"] = None
    import numpy as np
    import torch
    torch.set_num_threads(2)
    import scythe_tpu_torch as tx
    from scythe_tpu_torch.ops import column_solve, elementwise_probe, rlz_analysis
    from scythe_tpu_torch.examples import tc_intensification_rlz  # noqa: F401
    from scythe_tpu_torch.examples import convective_shower_xyz  # noqa: F401
    from scythe_tpu_torch.examples import williamson_sphere as wm
    from scythe_tpu_torch.examples import cha_bell_initialization as cb
    from scythe_tpu_torch.examples import calibrate_drag, jw06_baroclinic_slz  # noqa: F401
    from scythe_tpu_torch.examples import assimilate_4dvar, assimilate_enkf  # noqa: F401
    from scythe_tpu_torch import adjoint, balance  # noqa: F401
    from scythe_tpu_torch.equations import sphere  # noqa: F401
    from scythe_tpu_torch.physics import turbulence  # noqa: F401
    from scythe_tpu_torch import diagnostics  # noqa: F401
    from scythe_tpu_torch.basis import fourier_factored  # noqa: F401
    from scythe_tpu_torch.ops import bf16x3  # noqa: F401
    from scythe_tpu_torch.equations.common import REGISTRY, get_equation_set

    tmp = tempfile.mkdtemp()
    gp = tx.GridParameters(
        geometry="RLZ", xmin=0.0, xmax=8000.0, num_cells=4, lDim=8,
        zmin=0.0, zmax=8000.0, zDim=8,
        BCL={"u": tx.BC.R1T0, "v": tx.BC.R1T0, "w": tx.BC.R1T1},
        BCR={"u": tx.BC.R1T0, "v": tx.BC.R0},
        vars=("s", "xi", "mu", "u", "v", "w", "mu_c", "mu_r", "qss"),
    )
    with open(os.path.join(tmp, "snd.txt"), "w") as f:
        f.write("1015.0 300.0 14.0\\n")
        for z in np.linspace(300.0, 12000.0, 20):
            f.write(f"{z} {300.0 + 0.004 * z} {14.0 * np.exp(-z / 2500.0)}\\n")
    pts = tx.create_grid(gp, torch.float64, device="cpu").gridpoints()
    cols = np.zeros((len(pts), 12))
    cols[:, :3] = pts
    cols[:, 3] = 2.0 * np.exp(-((pts[:, 0] - 3000.0) ** 2 + (pts[:, 2] - 2000.0) ** 2) / 1e6)
    np.savetxt(os.path.join(tmp, "ics.csv"), cols, delimiter=",", comments="",
               header="r,l,z," + ",".join(gp.vars))
    model = tx.ModelParameters(
        ts=0.25, integration_time=0.75, output_interval=0.75,
        equation_set="MoistEulerRLZ",
        initial_conditions=os.path.join(tmp, "ics.csv"),
        output_dir=os.path.join(tmp, "out"),
        ref_state_file=os.path.join(tmp, "snd.txt"), grid_params=gp,
        physical_params={"K": 10.0, "f": 5e-5}, options={"semiimplicit": True},
    )
    grid, phys = tx.integrate_model(model, dtype=torch.float64, device="cpu")
    assert np.isfinite(phys).all() and phys.shape == (9, 12, 8, 8)
    from scythe_tpu_torch import trace
    launched = trace.process()
    for k in ("column_solve.launches", "rlz_analysis.launches", "elementwise_probe.launches"):
        assert (launched.total(k) or 0) == 0, k
    assert "triton" not in sys.modules
    assert not any(m == "jax" or m.startswith(("jax.", "scythe_tpu."))
                   for m in sys.modules if sys.modules[m] is not None)
    # the flagship two-way slab model, and every equation set registered
    fm = cb.flagship_model(8, 8)
    fg = tx.create_grid(fm.grid_params, torch.float64, device="cpu")
    from scythe_tpu_torch import model as tmodel
    fstep = tmodel.build_step(fm, fg, tmodel.build_context(fm, fg, torch.float64),
                              torch.float64)
    fout = tmodel.make_scan(fstep, 3)(cb.vortex_state(fg, torch.float64))
    assert torch.isfinite(fout.spec).all() and fout.t == 4
    get_equation_set("Twoway_ShallowWater_Slab")
    assert len(REGISTRY) == 21, sorted(REGISTRY)
    # Williamson case 2 on the SL sphere, 3 steps with NetCDF output
    w2 = wm.williamson2_model(os.path.join(tmp, "w2")).with_(
        integration_time=900.0, output_interval=900.0, options={"output_format": "nc"})
    _, wphys = tx.integrate_model(w2, dtype=torch.float64, device="cpu")
    assert np.isfinite(wphys).all() and wphys.shape == (3, 96, 96)
    assert "physical_out_900.0.nc" in os.listdir(os.path.join(tmp, "w2"))
    # the kernels' wrappers carry their Functions' graphs
    from scythe_tpu_torch import timeintegration as tti
    op = tti.build_semiimplicit_ops(8, 0.0, 8000.0, None, 9.0e4, 0.25, torch.float64,
                                    "cpu").solve
    xs = torch.ones((3, 8), dtype=torch.float64, requires_grad=True)
    w_new, xi_new = column_solve.apply_column_operator(xs, xs.detach(), op)
    assert type(w_new.grad_fn).__name__ == "ColumnSolveFnBackward", w_new.grad_fn
    g = tx.create_grid(gp, torch.float64, device="cpu")
    ph = torch.ones((9,) + g.spatial_shape, dtype=torch.float64, requires_grad=True)
    sp = rlz_analysis.rlz_analysis(ph, g.l_analysis, g.ring_mask, g.analysis_r, g.analysis_z)
    assert type(sp.grad_fn).__name__ == "RLZAnalysisFnBackward", sp.grad_fn
    assert type(g.analysis(ph).grad_fn).__name__ == "RLZAnalysisFnBackward"
    # a gradient through two flagship steps, and a two-member moist ensemble
    sim, sg, _ = tx.make_simulator(cb.flagship_model(8, 8), torch.float64, n_steps=2,
                                   device="cpu")
    p0 = torch.from_numpy(cb.vortex_phys(sg)).requires_grad_(True)
    (gp0,) = torch.autograd.grad(sim({}, p0)[2].sum(), p0)
    assert torch.isfinite(gp0).all() and float(gp0.abs().max()) > 0.0
    ics = tx.io.read_physical_grid(model.initial_conditions, g)
    _, ens = tmodel.integrate_ensemble(model.with_(integration_time=0.5),
                                       np.stack([ics, 2.0 * ics]), dtype=torch.float64,
                                       device="cpu")
    assert ens.shape == (2, 9, 12, 8, 8) and np.isfinite(ens).all()
    assert not any(m == "jax" or m.startswith(("jax.", "scythe_tpu."))
                   for m in sys.modules if sys.modules[m] is not None)
    # the compensated mode and the factored DFT build and transform
    cg = tx.create_grid(gp, matmul="compensated", device="cpu")
    assert cg.comp and cg.fast and torch.isfinite(cg.analysis(ph.detach().float())).all()
    fg4 = tx.create_grid(tx.GridParameters(geometry="RL", num_cells=2, xmax=1.0, lDim=4096,
                                           vars=("h",)), torch.float64, device="cpu")
    assert fg4.l_fact is not None and fg4.kDim == fourier_factored.FactoredDFT(4096).K
    # integrate_sharded: 3 steps on 2 thread-shards by psum and by halo
    from scythe_tpu_torch.parallel import mesh as pmesh, schur, sharding as psh  # noqa: F401
    agp = tx.GridParameters(geometry="R", xmin=-8.0, xmax=8.0, num_cells=16,
                            BCL={"u": tx.BC.PERIODIC}, BCR={"u": tx.BC.PERIODIC},
                            vars={"u": 1})
    ar = tx.create_grid(agp, torch.float64, device="cpu").r_mish
    np.savetxt(os.path.join(tmp, "adv.csv"), np.stack([ar, np.exp(-ar ** 2)], 1),
               delimiter=",", comments="", header="r,u")
    am = tx.ModelParameters(
        ts=0.05, integration_time=0.15, output_interval=0.15,
        equation_set="LinearAdvection1D", initial_conditions=os.path.join(tmp, "adv.csv"),
        output_dir=os.path.join(tmp, "adv_out"), grid_params=agp,
        physical_params={"c_0": 1.0, "K": 0.1},
    )
    _, aref = tx.integrate_model(am, torch.float64, write_outputs=False, device="cpu")
    for method in ("psum", "halo"):
        _, aout = psh.integrate_sharded(am, 2, torch.float64, method=method,
                                        write_outputs=False, device="cpu")
        assert np.abs(aout - aref).max() < 1e-12, method
    # the last examples, the model configs, the CLI and the harness entry
    from scythe_tpu_torch.examples import (  # noqa: F401
        analyze_tc, bf02_moist_benchmark, galewsky_instability, inertia_gravity_wave,
        linear_advection_example, straka_density_current, warm_bubble)
    from scythe_tpu_torch import __main__ as tmain, cli, graft_entry  # noqa: F401
    import importlib
    os.chdir(tmp)
    for name in ("linear_advection_1d", "moist_euler_rlz_demo", "tc_mature_rlz",
                 "williamson2_sphere", "cha_bell2024.common", "cha_bell2024.oneway",
                 "cha_bell2024.oneway_spinup", "cha_bell2024.twoway",
                 "cha_bell2024.twoway_tpu"):
        mod = importlib.import_module("scythe_tpu_torch.models." + name)
        assert isinstance(getattr(mod, "model", None) or mod.GRID,
                          (tx.ModelParameters, tx.GridParameters)), name
    assert os.path.exists(os.path.join(tmp, "tc_mature", "ics.csv"))
    with open(os.path.join(tmp, "adv_cfg.py"), "w") as f:
        print(f"model = __import__('pickle').load(open({os.path.join(tmp, 'am.pkl')!r}, 'rb'))",
              file=f)
    import pickle
    with open(os.path.join(tmp, "am.pkl"), "wb") as f:
        pickle.dump(am.with_(output_dir=os.path.join(tmp, "cli_out")), f)
    assert cli.main(["--platform", "cpu", "--dtype", "f64", "-d", "2",
                     os.path.join(tmp, "adv_cfg.py")]) == 0
    assert "physical_out_0.15.csv" in os.listdir(os.path.join(tmp, "cli_out"))
    fn, (st,) = graft_entry.entry(torch.float64, device="cpu")
    assert torch.isfinite(fn(st).spec).all()
    assert not any(m == "jax" or m.startswith(("jax.", "scythe_tpu."))
                   for m in sys.modules if sys.modules[m] is not None)
    print("NOJAX_OK", sorted(os.listdir(os.path.join(tmp, "out"))))
    """
)


def test_port_imports_and_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NOJAX_OK" in proc.stdout
    assert "physical_out_0.75.csv" in proc.stdout


GRAPH_SCRIPT = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None
    sys.modules["scythe_tpu"] = None
    import inspect
    import torch
    torch.set_num_threads(2)
    import scythe_tpu_torch as tx
    from scythe_tpu_torch import graphs, model as tmodel
    from scythe_tpu_torch.examples import cha_bell_initialization as cb

    assert tmodel.disable_graphs is graphs.disable_graphs
    assert inspect.signature(graphs.scan).parameters["capture"].default is None
    assert isinstance(graphs.CUDA_GRAPH, graphs.CudaGraph)
    model = cb.flagship_model(4, 8)
    grid = tx.create_grid(model.grid_params, torch.float64, device="cpu")
    step = tmodel.build_step(model, grid, tmodel.build_context(model, grid, torch.float64),
                             torch.float64)
    s0 = cb.vortex_state(grid, torch.float64)

    class Replay:  # the captured function, called again
        def warm(self, fn, device):
            fn()

        def capture(self, fn, device, buffers):
            return fn

    eager = tmodel.make_scan(step, 6)(s0)
    assert not graphs.captured(step)
    with tmodel.disable_graphs():
        assert graphs.graphs_disabled()
        assert graphs.scan(step, 6, s0, capture=Replay()).t == 7
        assert not graphs.captured(step)
    got = graphs.scan(step, 6, s0, capture=Replay())
    assert all(torch.equal(a, b) for a, b in zip(got[:5], eager[:5]))
    (runner,) = graphs.captured(step).values()
    assert runner.replays == 3
    assert "triton" not in sys.modules
    assert not any(m == "jax" or m.startswith(("jax.", "scythe_tpu."))
                   for m in sys.modules if sys.modules[m] is not None)
    print("GRAPHS_NOJAX_OK")
    """
)


def test_graph_runner_imports_and_runs_without_jax():
    """graphs.py and make_scan's runner (disable_graphs, the default
    CUDA_GRAPH primitive, a stand-in primitive on the CPU) with jax and the
    JAX package blocked."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
    proc = subprocess.run([sys.executable, "-c", GRAPH_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "GRAPHS_NOJAX_OK" in proc.stdout


def test_port_source_never_imports_jax():
    pkg = os.path.join(REPO, "scythe_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    for line in f:
                        s = line.strip()
                        assert not s.startswith(("import jax", "from jax")), (name, s)
                        assert not s.startswith(("import scythe_tpu.", "from scythe_tpu ",
                                                 "from scythe_tpu.")), (name, s)


def _package_imports(path, package):
    """The package's modules that the module at ``path`` (named ``package``
    plus its own name) imports, at its top or inside a function."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names if a.name.split(".")[0] == "scythe_tpu_torch"}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                parts = package.split(".")
                base = parts[:len(parts) - node.level]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module or ""
            if mod.split(".")[0] == "scythe_tpu_torch":
                out |= {mod} | {f"{mod}.{a.name}" for a in node.names}
    return out


def test_layers_point_one_way():
    """No module of ``physics/`` or ``ops/`` imports the graph runner, and
    the trace registry imports no module of the package."""
    pkg = os.path.join(REPO, "scythe_tpu_torch")
    for sub in ("physics", "ops"):
        for name in sorted(os.listdir(os.path.join(pkg, sub))):
            if name.endswith(".py"):
                got = _package_imports(os.path.join(pkg, sub, name),
                                       f"scythe_tpu_torch.{sub}.{name[:-3]}")
                assert "scythe_tpu_torch.graphs" not in got, (sub, name, got)
    assert _package_imports(os.path.join(pkg, "trace.py"), "scythe_tpu_torch.trace") == set()
