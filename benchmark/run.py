"""Run one cell of the benchmark once on one H100 and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is the entry of ``BENCHMARK.json``'s
``workloads`` with that name; ``benchmark/harness.py`` sets it up, warms it
up, measures one window of about ``--seconds`` with the driver the cell's
traffic names (``benchmark/drivers/``; ``run_loop``: one ``model.run_loop``
call), and compares what the window produced with the plain reference
(``benchmark/reference``).  With ``--trace 0`` the result carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a traced segment of the window's path after the window (the profiler;
CUDA events for a step's device time) and from the window's own spans.  Earlier
lines of standard output say which CSV writer ran, what the window wrote,
the card and its power limit and (traced) how each kernel name was
classed; the last lines of standard error give each compared number beside
its limit; the last line of standard output is the result, one JSON
object.  Without a card, or with fewer cards than the cell asks for, it
exits with code 2 and prints no result; where the process has loaded JAX or
the JAX package by the end, with code 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "scythe_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """The top-level names in ``sys.modules`` (the part before the first
    dot, compared whole) that are JAX's or the JAX package's."""
    tops = {name.split(".", 1)[0] for name in (sys.modules if modules is None else modules)}
    return sorted(tops & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi failed: {e}"
    return out.splitlines()[0] if out else "nvidia-smi gave nothing"


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    # one process with few threads: the host's share of the window (graph
    # launches, the fetch, the CSV write) reads steadier without idle
    # BLAS and OpenMP pools beside it
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    # every build and kernel cache inside the checkout, at fixed paths
    cache = os.path.join(ROOT, "benchmark", "_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"the cell needs {entry['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from benchmark import harness

    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t_start=T_START)
    r = out.result
    for note in out.notes:
        print(note)
    print(f"card {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    found = forbidden_modules()
    if found:
        print(f"the process loaded {found}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3

    if args.trace:
        rec = r["record"]
        metrics = {}
        for m in bench["per_layer"]:
            if not applies(m, args.workload) or rec is None:
                continue
            value = harness.metric_reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": r["setup_s"], **r["end_to_end"]}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"]
                   if applies(m, args.workload) and values.get(m["name"]) is not None}

    checks = {k: {"value": v, "limit": lim} for k, (v, lim, _) in out.checks.items()}
    correct = harness.decide(r, out.checks)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": entry["chips"],
              "memory_peak_bytes": r["peak_bytes"]}
    if args.trace and r["record"] is not None and r["record"].window_s:
        device["busy_s"] = r["record"].busy_s
        device["window_s"] = r["record"].window_s
    result = {"correct": correct, "attempted": r["attempted"], "failed": r["failed"],
              "metrics": metrics, "device": device}
    if r["breakdown"] is not None:
        result["breakdown"] = r["breakdown"]
    result["checks"] = checks

    for k, (v, lim, per_var) in out.checks.items():
        print(f"{k} per variable: {json.dumps(per_var)}", file=sys.stderr)
    sys.stderr.flush()
    for k, c in checks.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
