#!/usr/bin/env python3
"""How often a rank of a two-process gloo run aborts as it exits, by the
way the rank leaves.

    python3 tools/torch_gloo_teardown_check.py [--runs 100] [--pairs 2]

Each run is two processes over gloo (a FileStore rendezvous, no network)
that take the flagship at a small size (8 cells x 16, float64, the CPU) 10
halo steps on a DistMesh of 2 (the halo case of the gloo test aborted
once), gather the result and then leave in one of four ways:

* keep: with the group still initialised;
* destroy: after ``destroy_process_group()``;
* barrier: after a barrier and ``destroy_process_group()``;
* os-exit: as barrier, then ``os._exit(0)``, without the interpreter's
  teardown (tests/test_torch_sharded_runs.py's rank script).

Each round starts ``--pairs`` runs of every way at once, so the ways share
the load.  It prints one JSON object: for each way, the runs, the ranks
that aborted (SIGABRT), the ranks that failed otherwise, and the end of the
first abort's standard error.  A development tool of scythe_tpu_torch; no
main path runs it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RANK = """
import faulthandler, os, sys
faulthandler.enable()
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, store, way = sys.argv[1:4]
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=int(rank),
                        world_size=2)
from scythe_tpu_torch import create_grid
from scythe_tpu_torch import model as tmodel
from scythe_tpu_torch.examples import cha_bell_initialization as cb
from scythe_tpu_torch.parallel import sharding as sh
f64 = torch.float64
m = cb.flagship_model(8, 16)
g = create_grid(m.grid_params, f64, device="cpu")
ctx = tmodel.build_context(m, g, f64)
st = cb.vortex_state(g, f64)
mesh = sh.make_mesh(device="cpu")
st = st._replace(spec=sh.spec_to_blocks(st.spec, 2, 4))
step = sh.build_sharded_step(m, g, ctx, f64, mesh, "halo")
fin = tmodel.make_scan(step, 10)(sh.shard_state(st, mesh, "halo"))
assert torch.isfinite(sh.gather_global(fin.spec)).all()
if way in ("barrier", "os-exit"):
    dist.barrier()
if way != "keep":
    dist.destroy_process_group()
if way == "os-exit":
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
"""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=100, help="runs of each way")
    ap.add_argument("--pairs", type=int, default=2, help="runs of each way at once")
    args = ap.parse_args(argv)
    ways = ("keep", "destroy", "barrier", "os-exit")
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
    env["PYTHONPATH"] = ROOT
    out = {w: {"runs": 0, "aborted_ranks": 0, "failed_ranks": 0, "first_abort": None}
           for w in ways}
    tmp = tempfile.mkdtemp(prefix="gloo_teardown_")
    try:
        done = 0
        while done < args.runs:
            batch = min(args.pairs, args.runs - done)
            procs = []
            for w in ways:
                for b in range(batch):
                    store = os.path.join(tmp, f"store_{w}_{done + b}")
                    procs += [(w, subprocess.Popen(
                        [sys.executable, "-c", RANK, str(r), store, w],
                        cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                        stderr=subprocess.PIPE, text=True)) for r in range(2)]
            for w, p in procs:
                try:
                    _, err = p.communicate(timeout=300)
                finally:
                    p.kill()
                rec = out[w]
                if p.returncode == -signal.SIGABRT:
                    rec["aborted_ranks"] += 1
                    rec["first_abort"] = rec["first_abort"] or err[-1500:]
                elif p.returncode != 0:
                    rec["failed_ranks"] += 1
                    rec.setdefault("first_failure", err[-1500:])
            for w in ways:
                out[w]["runs"] += batch
            done += batch
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
