#!/usr/bin/env python3
"""The readings behind chip_smoke.py's compensated phases, from the PyTorch
port on any device: moist3d at full width (bench.py's configuration,
[9, 144, 64, 48], ts 0.15 s) for 20 steps on a compensated grid in float32
(deriv_single auto: on) and on a plain grid in float32, each against the
plain float64 run; then the Cha & Bell flagship workflow (200 spinup + 400
two-way steps at full width) on compensated grids in float32 and on plain
grids in float64, as chip_smoke.py's comp_flagship and flagship phases drive
them.

    python3 tools/torch_comp_reference.py [--device cpu] [--threads 8]
                                          [--steps 20] [--small]

It prints one JSON object: the device, the per-field relative errors
(max|a - b| / max|b|) of compensated f32 and plain f32 against plain f64
after the moist3d steps, and the flagship readings of each run.  Run it on
the CPU for the reference reading; chip_smoke.py's COMP_M3D bounds are set
around what it prints.  ``--small`` takes the small moist configuration and
20 two-way steps instead (a rehearsal of the script).  A development tool of
scythe_tpu_torch; no main path runs it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    import scythe_tpu_torch as tx
    from scythe_tpu_torch.examples import cha_bell_initialization as cb

    torch.set_num_threads(args.threads)
    tmp = tempfile.mkdtemp(prefix="comp_reference_")
    out = {"device": args.device, "steps": args.steps}
    try:
        t0 = time.perf_counter()
        if args.small:
            m = smoke.small(tx, tmp, args.steps)
        else:
            m = smoke.moist3d(tx, tmp, args.steps, args.steps)
        runs = {}
        for label, dtype, comp in (("comp_f32", torch.float32, True),
                                   ("plain_f32", torch.float32, False),
                                   ("plain_f64", torch.float64, False)):
            with smoke.compensated_grids() if comp else contextlib.nullcontext():
                _, runs[label] = tx.integrate_model(m, dtype=dtype, device=args.device,
                                                    write_outputs=False)
        for label in ("comp_f32", "plain_f32"):
            out[f"moist3d_{label}_vs_f64"] = dict(zip(
                smoke.MOIST3D_VARS, smoke.per_field_rel(runs[label], runs["plain_f64"])))
        out["moist3d_seconds"] = time.perf_counter() - t0

        steps = 20 if args.small else 400
        for label, dtype, comp in (("flagship_comp_f32", torch.float32, True),
                                   ("flagship_plain_f64", torch.float64, False)):
            t0 = time.perf_counter()
            base = os.path.join(tmp, label)
            if comp:
                _, grid, phys = smoke.comp_flagship_workflow(tx, torch, cb, base, dtype,
                                                             args.device, steps)
            else:
                _, grid, phys = smoke.flagship_workflow(tx, cb, base, dtype, args.device,
                                                        steps)
            out[label] = {"seconds": time.perf_counter() - t0, "fast": grid.fast,
                          **smoke.flagship_readings(grid, phys)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
