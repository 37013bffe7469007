"""Readings behind the limits of a cell's checks, on the card, in one
process: for each seed, one run of the cell as ``run.py`` makes it (set-up,
warm-up, a window of ``--seconds``), judged against the float64 reference
(the program's readings), and the control judged the same way: the
reference in float32 with its GEMMs on TF32, the nearest precision below
the cell's float32 with TF32 off, put in the program's place on the same
inputs and the same state entering the judged interval.

    python3 benchmark/control.py --workload tc_mature.f32 --seeds 11,12,13 \\
        --seconds 5 [--out readings.jsonl]

Prints one JSON line a seed: {"seed", "program": {check: {variable:
gap}}, "control": {...}}.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell_name, seed, seconds, device="cuda", bench_dir=None, control=True):
    """(program run's counts, {"program": ..., "control": ...}) of one seed."""
    import torch

    from benchmark import harness

    bench_dir = Path(bench_dir) if bench_dir else harness.BENCH
    cell = harness.load_cell(cell_name, bench_dir)
    run_dir = Path(os.environ.get("TMPDIR", "/tmp")) / f"scythe_control_{cell_name}_{seed}"
    try:
        pr = harness.program_run(cell, seed, run_dir, device)
        pr.setup()
        pr.plan(seconds)
        wall, done, steps, error = pr.window(False)
        if error is not None:
            return {"error": str(error)}, {}
        pr.release()
        ctl = (harness.Reference(pr.reference_model(), pr.phys0, torch.float32, device,
                                 tf32=True) if control else None)
        t0 = time.perf_counter()
        sides = pr.judge(device, ctl)
        run = {"intervals": pr.attempted, "done": done, "steps_per_s": steps / wall,
               "judge_s": time.perf_counter() - t0}
        return run, sides
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def witness(cell_name, seed, device="cuda", bench_dir=None):
    """{precision: simulated seconds at the first non-finite field, or None}
    of the plain reference alone from the seed's inputs, in float64 and in
    float32 (TF32 off), over the published run length (``published``
    ``integration_time`` of the configuration, else its own), an output
    interval at a time: whether a run of that length stays finite."""
    import numpy as np
    import torch

    from benchmark import harness

    cell = harness.load_cell(cell_name, Path(bench_dir) if bench_dir else harness.BENCH)
    run_dir = Path(os.environ.get("TMPDIR", "/tmp")) / f"scythe_witness_{cell_name}_{seed}"
    try:
        pr = harness.program_run(cell, seed, run_dir, device)
        m = pr.cfg["model"]
        t_end = pr.cfg.get("published", {}).get("integration_time", m["integration_time"])
        out = {}
        for name, dtype in (("float64", torch.float64), ("float32", torch.float32)):
            ref = harness.Reference(pr.reference_model(), pr.phys0, dtype, device)
            st, out[name] = ref.state0, None
            for k in range(int(round(t_end / m["ts"])) // pr.n_out):
                st = ref.run(st, pr.n_out)
                if not np.isfinite(ref.fields(st)).all():
                    out[name] = (k + 1) * pr.n_out * m["ts"]
                    break
            del ref
        return out
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--witness", action="store_true",
                    help="only run the reference over the published run length")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.witness:
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "non_finite_at_s": witness(args.workload, seed)})
        else:
            run, sides = readings(args.workload, seed, args.seconds)
            line = json.dumps({"workload": args.workload, "seed": seed, "run": run, **sides})
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
