#!/usr/bin/env python3
"""The readings behind chip_smoke.py's flagship bands, from the PyTorch port
on any device: the Cha & Bell two-layer workflow at full width (100 cells x
256 azimuths) exactly as chip_smoke.py's flagship phase drives it (Rankine
ICs, 200 one-way spinup steps, add_wave2, 400 two-way steps), then the
two-way model 50 steps from the wave-2 ICs in float32 against float64.

    python3 tools/torch_flagship_reference.py [--device cpu] [--dtype float64]
                                              [--threads 4]

It prints one JSON object: the device, chip_smoke.flagship_readings of the
final fields (vg.max, the wavenumber-2 amplitude of vg at r = 50 km, ...) and
the per-field float32 / float64 relative error.  Run it on the CPU in
float64 for the reference reading; the bands and bounds of chip_smoke.py are
set around what it prints.  A development tool of scythe_tpu_torch; no main
path runs it.
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
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    import scythe_tpu_torch as tx
    from scythe_tpu_torch.examples import cha_bell_initialization as cb

    torch.set_num_threads(args.threads)
    dtype = getattr(torch, args.dtype)
    tmp = tempfile.mkdtemp(prefix="flagship_reference_")
    try:
        t0 = time.perf_counter()
        tw, grid, phys = smoke.flagship_workflow(tx, cb, tmp, dtype, args.device)
        seconds = time.perf_counter() - t0
        tw50 = tw.with_(integration_time=150.0, output_interval=150.0)
        _, p32 = tx.integrate_model(tw50, dtype=torch.float32, device=args.device,
                                    write_outputs=False)
        _, p64 = tx.integrate_model(tw50, dtype=torch.float64, device=args.device,
                                    write_outputs=False)
        rel = smoke.per_field_rel(p32, p64)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({
        "device": args.device,
        "dtype": args.dtype,
        "workflow_steps": 200 + tw.num_ts,
        "workflow_seconds": seconds,
        "readings": smoke.flagship_readings(grid, phys),
        "f32_vs_f64_50_steps": dict(zip(smoke.FLAGSHIP_VARS, rel)),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
