"""The port's CLI (``python -m scythe_tpu_torch``, scythe_tpu_torch/cli.py),
end to end in subprocesses on the CPU, as tests/test_cli.py and
tests/test_multihost.py drive run_scythe.py: LinearAdvection1D (64 cells,
200 steps) in float64 on 1, on 4 thread-shards (psum) and on 4 halo
thread-shards (a ThreadMesh in place of the 8 XLA host devices) agree at
1e-12; two processes over gloo (``--multihost`` with a tcp:// rendezvous on
127.0.0.1) match one process at 1e-12, by psum and by halo.  Without
``--platform cpu`` the CLI asks for the card and, with none, raises.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import scythe_tpu_torch as tx
from scythe_tpu_torch import cli
from scythe_tpu_torch.io import _write_csv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**{k: v for k, v in os.environ.items() if not k.startswith("JAX_")},
       "OMP_NUM_THREADS": "2"}

CONFIG = """
from scythe_tpu_torch import BC, GridParameters, ModelParameters

model = ModelParameters(
    ts=0.05, integration_time={t_end}, output_interval={t_end},
    equation_set="LinearAdvection1D",
    initial_conditions=r"{tmp}/ics.csv",
    output_dir=r"{tmp}/{out}/",
    grid_params=GridParameters(
        geometry="R", xmin=-50.0, xmax=50.0, num_cells=64,
        BCL={{"u": BC.PERIODIC}}, BCR={{"u": BC.PERIODIC}}, vars={{"u": 1}}),
    physical_params={{"c_0": 1.0, "K": {K}}})
"""


def write_config(tmp_path, out, t_end=10.0, K=0.0):
    cfg = tmp_path / f"model_{out}.py"
    cfg.write_text(CONFIG.format(tmp=tmp_path, out=out, t_end=t_end, K=K))
    ics = tmp_path / "ics.csv"
    if not ics.exists():
        gp = tx.GridParameters(geometry="R", xmin=-50.0, xmax=50.0, num_cells=64,
                               BCL={"u": tx.BC.PERIODIC}, BCR={"u": tx.BC.PERIODIC},
                               vars={"u": 1})
        r = tx.create_grid(gp, torch.float64, device="cpu").r_mish
        _write_csv(str(ics), ["r", "u"], np.stack([r, np.exp(-(r / 15.0) ** 2)], 1))
    return cfg


def run_cli(cfg, *flags):
    res = subprocess.run(
        [sys.executable, "-m", "scythe_tpu_torch", "--platform", "cpu", "--dtype", "f64",
         *flags, str(cfg)],
        env=ENV, capture_output=True, text=True, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "All done!" in res.stdout
    return res


def output(tmp_path, out, t="10.0"):
    data = np.loadtxt(tmp_path / out / f"physical_out_{t}.csv", delimiter=",", skiprows=1)
    assert np.isfinite(data).all()
    return data


@pytest.mark.parametrize("devices", [1, 4])
def test_cli_run(tmp_path, devices):
    """test_cli.py:54."""
    run_cli(write_config(tmp_path, f"out{devices}"), "-d", str(devices))
    output(tmp_path, f"out{devices}")


def test_cli_runs_agree_across_device_counts(tmp_path):
    """test_cli.py:87: 1, 4 and 4-halo runs agree at 1e-12."""
    for out, flags in (("out1", ["-d", "1"]), ("out4", ["-d", "4"]),
                       ("out4halo", ["-d", "4", "--shard-method", "halo"])):
        run_cli(write_config(tmp_path, out), *flags)
    a = output(tmp_path, "out1")
    np.testing.assert_allclose(output(tmp_path, "out4"), a, rtol=0, atol=1e-12)
    np.testing.assert_allclose(output(tmp_path, "out4halo"), a, rtol=0, atol=1e-12)


RANK = textwrap.dedent("""
    import os, sys
    from scythe_tpu_torch.cli import main
    main(sys.argv[1:])
    sys.stdout.flush()
    sys.stderr.flush()
    # leave without the interpreter's teardown, where a gloo rank can abort
    # after its work is done (tools/torch_gloo_teardown_check.py)
    os._exit(0)
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("method", ["psum", "halo"])
def test_two_process_cli_matches_single(tmp_path, method):
    """test_multihost.py:69: two processes of one shard each over gloo
    (--multihost, a tcp:// rendezvous) against one process, 1e-12."""
    port = _free_port()
    cfg = write_config(tmp_path, f"out_mp_{method}", t_end=5.0, K=0.1)
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, "--platform", "cpu", "--dtype", "f64", "--multihost",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
         str(pid), "-d", "2", "--shard-method", method, str(cfg)],
        env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
        for pid in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]
    assert "(torch.distributed)" in outs[0][0]
    run_cli(write_config(tmp_path, f"out_1_{method}", t_end=5.0, K=0.1))
    np.testing.assert_allclose(output(tmp_path, f"out_mp_{method}", "5.0"),
                               output(tmp_path, f"out_1_{method}", "5.0"), rtol=0, atol=1e-12)


def test_cli_runs_on_the_card_by_default(tmp_path, monkeypatch):
    """Without --platform the CLI asks for the card: with none it raises
    before it runs the config; a config without ``model`` exits."""
    cfg = write_config(tmp_path, "out")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main([str(cfg)])
    empty = tmp_path / "empty.py"
    empty.write_text("x = 1\n")
    with pytest.raises(SystemExit, match="must define"):
        cli.main(["--platform", "cpu", str(empty)])
    args = cli.parse_args([str(cfg)])
    assert (args.platform, args.devices, args.dtype, args.shard_method) == (
        "cuda", None, "f32", "psum")
