#!/usr/bin/env python3
"""The readings behind chip_smoke.py's JW06 bands, from the PyTorch port on
any device: the Jablonowski & Williamson (2006) baroclinic wave at its
production recipe (scythe_tpu_torch/examples/jw06_baroclinic_slz.py
production_model: 48 cells x 96 x 24, ts 7.5 s), its zonal mean balanced by
balance_zonal_state in float64 (on ``--balance-device``, by default the run's
device; chip_smoke.py holds the card's balance against the CPU's at a
reduced size), then ``--steps`` steps on ``--device``,
exactly as chip_smoke.py's JW06 phase drives them; then 20 steps in float32
against float64.

    python3 tools/torch_jw06_reference.py [--device cpu] [--dtype float64]
                                          [--threads 8] [--steps 480]
                                          [--cells 48] [--balance-device cuda]

It prints one JSON object: the device, the balance's residual history and
seconds, the readings of the final fields (the example's diagnostics and
|w| max) and the per-field float32 / float64 relative error after 20 steps.
Run it on the CPU in float64 for the reference reading (at 48 cells a
machine with some tens of GiB; 8 threads take minutes); the bands and
bounds of chip_smoke.py are set around what it prints.  A development tool
of scythe_tpu_torch; no main path runs it.
"""

from __future__ import annotations

import argparse
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
    ap.add_argument("--dtype", default="float64", choices=("float32", "float64"))
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--steps", type=int, default=480)
    ap.add_argument("--cells", type=int, default=48)
    ap.add_argument("--balance-device", default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    import scythe_tpu_torch as tx
    from scythe_tpu_torch import model as tmodel
    from scythe_tpu_torch.examples import jw06_baroclinic_slz as tw

    torch.set_num_threads(args.threads)
    dtype = getattr(torch, args.dtype)
    tmp = tempfile.mkdtemp(prefix="jw06_reference_")
    out = {"device": args.device, "dtype": args.dtype, "steps": args.steps,
           "cells": args.cells, "balance_device": args.balance_device or args.device}
    try:
        model, g64, c64, phys0, history, bal_s = smoke.jw06_case(
            tx, tmodel, tw, torch, os.path.join(tmp, "jw06"), args.steps,
            args.balance_device or args.device, cells=args.cells)
        out["balance"] = {"seconds": bal_s, "history": history}
        t0 = time.perf_counter()
        grid, _, state, step = tw.prepare_run(model, phys0, dtype, args.device)
        state = tmodel.make_scan(step, args.steps)(state)
        phys = grid.synthesis(state.spec)["val"].cpu().numpy()
        out["run_seconds"] = time.perf_counter() - t0
        out["finite"] = bool(np.isfinite(phys).all())
        out["readings"] = smoke.jw06_readings(tw, g64, c64, phys)
        runs = {}
        for dt in (torch.float32, torch.float64):
            g, _, st, sp = tw.prepare_run(model, phys0, dt, args.device)
            runs[dt] = g.synthesis(tmodel.make_scan(sp, 20)(st).spec)["val"].cpu().numpy()
        out["f32_vs_f64_20_steps"] = dict(zip(
            smoke.MOIST3D_VARS, smoke.per_field_rel(runs[torch.float32], runs[torch.float64])))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
