#!/usr/bin/env python3
"""The readings behind chip_smoke.py's bounds on its sharded runs, on the
CPU (or another device) exactly as chip_smoke.py's sharded phase drives
them on the card:

* moist3d: the JAX package's moist3d configuration (bench.py moist3d_model:
  48 cells x 64 x 48, 9 vars, ts 0.15 s) for 20 steps on one device and on
  4 psum thread-shards (scythe_tpu_torch.parallel), in float32 and in
  float64 (SHARDED_F32_BOUND);
* flagship: the flagship (100 cells x 256) for 50 float64 steps on one
  device and on 4 psum thread-shards (SHARDED_FLAGSHIP_BOUND).

    python3 tools/torch_sharded_reference.py [--device cpu] [--threads 8]
        [--steps 20] [--shards 4]
        [--parts moist3d,flagship]

It prints one JSON object: the device, and for each run the per-field
max|sharded - one device| / max|one device| of the final fields, and the
seconds each run took.  The shards sum the projection in another order
than one device, so the two part by round-off; chip_smoke.py's bounds are
set around what this prints on the CPU and what the card reads.  A
development tool of scythe_tpu_torch; no main path runs it.
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
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--parts", default="moist3d,flagship")
    args = ap.parse_args(argv)
    parts = set(args.parts.split(","))

    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    import scythe_tpu_torch as tx

    torch.set_num_threads(args.threads)
    tmp = tempfile.mkdtemp(prefix="sharded_reference_")
    out = {"device": args.device, "steps": args.steps, "shards": args.shards}
    try:
        model = smoke.moist3d(tx, tmp, n_steps=args.steps, out_every=args.steps)
        for name in ("float32", "float64") if "moist3d" in parts else ():
            dtype = getattr(torch, name)
            t0 = time.perf_counter()
            one = smoke.sharded_fields(tx, torch, model, dtype, args.device, None)
            t1 = time.perf_counter()
            four = smoke.sharded_fields(tx, torch, model, dtype, args.device,
                                        (args.shards, "psum", "gather"))
            t2 = time.perf_counter()
            out[name] = {
                "rel_err": dict(zip(smoke.MOIST3D_VARS, smoke.per_field_rel(four, one))),
                "seconds_one_device": t1 - t0, "seconds_sharded": t2 - t1,
            }
        if "flagship" in parts:
            t0 = time.perf_counter()
            rel = smoke.sharded_flagship_rel(tx, torch, args.device, shards=args.shards)
            out["flagship_float64"] = {
                "steps": 50,
                "rel_err": dict(zip(smoke.FLAGSHIP_VARS, rel)),
                "seconds": time.perf_counter() - t0,
            }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
