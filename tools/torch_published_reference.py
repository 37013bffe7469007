#!/usr/bin/env python3
"""The readings of the port's published-benchmark runs at their published
sizes, on any device, exactly as chip_smoke.py's examples group drives them
(chip_smoke.published_model / published_run): the warm bubble
(scythe_tpu_torch/examples/warm_bubble.py, 3,000 steps), Straka (128 x 48,
7,200 steps), the SK94 inertia-gravity wave (150 x 24, 4,000 steps), BF02
at the JAX test's 32 x 40 (bf02_gate, 4,000 steps) and at the published
64 x 64 (10,000 steps), and Galewsky (128 x 512, float64 whatever
``--dtype`` says, ``--galewsky-days`` days).

    python3 tools/torch_published_reference.py [--device cpu] [--dtype float64]
        [--threads 4] [--runs warm_bubble,straka,igw,bf02_gate,bf02,galewsky]
        [--galewsky-days 1]

It prints one JSON line a run (its readings and its seconds) and one with
all of them.  Run it on the CPU in float64 for the reference readings that
PERF.md sets chip_smoke.py's f32 runs beside (and that chip_smoke.py's
GALEWSKY_CPU_F64 holds).  A development tool of scythe_tpu_torch; no main
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
RUNS = ("warm_bubble", "straka", "igw", "bf02_gate", "bf02", "galewsky")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--dtype", default="float64", choices=("float32", "float64"))
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--runs", default=",".join(RUNS))
    ap.add_argument("--galewsky-days", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as smoke
    from scythe_tpu_torch.examples import galewsky_instability as gw

    torch.set_num_threads(args.threads)
    dtype = getattr(torch, args.dtype)
    base = tempfile.mkdtemp(prefix="published_")
    out = {"device": args.device, "dtype": args.dtype}
    try:
        for name in args.runs.split(","):
            t0 = time.perf_counter()
            if name == "galewsky":
                model = gw.build_model(128, args.galewsky_days)
                r = {d: gw.day_readings(f)[:2]
                     for d, f in gw.run_days(model, args.galewsky_days, args.device)}
            else:
                r = smoke.published_run(name, smoke.published_model(name, base), dtype,
                                        args.device)
            out[name] = {"readings": r, "seconds": time.perf_counter() - t0}
            print(json.dumps({name: out[name]}), flush=True)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
