#!/usr/bin/env python3
"""The readings behind chip_smoke.py's convective-shower bands, from the
PyTorch port on any device: the convective shower of
scythe_tpu_torch/examples/convective_shower_xyz.py at its own width (48 cells
x 16 x 32, ts 0.25 s) for 240 steps (60 s), once with the example's options
and once under profile='moist_production', exactly as chip_smoke.py's shower
phase drives them; then 20 steps of the example in float32 against float64.

    python3 tools/torch_shower_reference.py [--device cpu] [--dtype float64]
                                            [--threads 4] [--steps 240]

It prints one JSON object: the device, the readings of each run's final
fields (convective_shower_xyz.readings: the w range, the cloud water and
rain maxima) and the per-field float32 / float64 relative error after 20
steps.  Run it on the CPU in float64 for the reference reading; the bands
and bounds of chip_smoke.py are set around what it prints.  A development
tool of scythe_tpu_torch; no main path runs it.
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
    ap.add_argument("--steps", type=int, default=240)
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    import scythe_tpu_torch as tx
    from scythe_tpu_torch.examples import convective_shower_xyz as shower

    torch.set_num_threads(args.threads)
    dtype = getattr(torch, args.dtype)
    tmp = tempfile.mkdtemp(prefix="shower_reference_")
    out = {"device": args.device, "dtype": args.dtype, "steps": args.steps}
    try:
        for profile in (None, "moist_production"):
            t0 = time.perf_counter()
            model = smoke.shower(tx, shower, os.path.join(tmp, str(profile)), args.steps,
                                 profile)
            _, phys = tx.integrate_model(model, dtype=dtype, device=args.device,
                                         write_outputs=False)
            out[profile or "example"] = {"seconds": time.perf_counter() - t0,
                                         **shower.readings(phys)}
        m20 = smoke.shower(tx, shower, os.path.join(tmp, "f32"), 20, None)
        _, p32 = tx.integrate_model(m20, dtype=torch.float32, device=args.device,
                                    write_outputs=False)
        _, p64 = tx.integrate_model(m20, dtype=torch.float64, device=args.device,
                                    write_outputs=False)
        out["f32_vs_f64_20_steps"] = dict(zip(smoke.MOIST3D_VARS,
                                              smoke.per_field_rel(p32, p64)))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
