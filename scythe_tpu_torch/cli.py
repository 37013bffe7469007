"""CLI launcher, the port of ``run_scythe.py`` (ref run_Scythe.jl).

Usage:
    python -m scythe_tpu_torch [options] model_file.py

The model file is executable config (as in the reference, README.md:27): a
Python script that defines a ``model = ModelParameters(...)`` variable, from
``scythe_tpu_torch`` (the port's copies of the JAX package's configs are in
``scythe_tpu_torch/models/``).  The run is on the card unless ``--platform
cpu`` is given.  ``-d n`` splits the radial dimension over n shards of this
process (a ``ThreadMesh``: threads taking turns on the card, or on the CPU);
``--multihost`` joins a torch.distributed group (NCCL on the card, gloo on
the CPU), one shard a process: by ``--coordinator host:port``,
``--num-processes`` and ``--process-id`` (a ``tcp://`` rendezvous), or else
by the ``env://`` variables that ``torchrun`` sets.
"""

from __future__ import annotations

import argparse
import os
import runpy
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m scythe_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model", help="Python file defining `model = ModelParameters(...)`")
    p.add_argument(
        "-d",
        "--devices",
        type=int,
        default=None,
        help="number of shards to split the radial dimension over (default 1; "
        "with --multihost, the group's size, one shard a process)",
    )
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32",
                   help="working precision")
    p.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                   help="where the run goes: the card (default) or the CPU")
    p.add_argument(
        "--multihost",
        action="store_true",
        help="join a torch.distributed group (NCCL on cuda, gloo on cpu): "
        "--coordinator/--num-processes/--process-id for a manual launch, "
        "else the env:// variables of torchrun",
    )
    p.add_argument("--coordinator", default=None, help="host:port of process 0")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument(
        "--shard-method",
        choices=["psum", "halo"],
        default="psum",
        help="sharded-analysis method: psum (replicated spectral, small "
        "meshes) or halo (Schur solve, O(halo) comms, scalable)",
    )
    p.add_argument(
        "--shard-interface",
        choices=["auto", "gather", "pcr"],
        default="auto",
        help="halo-method interface solve: gather (all_gather + dense "
        "inverse rows, O(n)) or pcr (parallel cyclic reduction, O(log n) "
        "ppermutes); auto = pcr at n >= 16",
    )
    p.add_argument("--format", choices=["csv", "nc"], default=None,
                   help="output format: reference-schema CSV (default) or CF NetCDF")
    p.add_argument("--resume-from", default=None,
                   help="binary checkpoint .npz to resume from")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace here and time the step's stages")
    return p.parse_args(argv)


def init_multihost(args, device: str) -> None:
    """Join the torch.distributed group the flags name: NCCL on the card
    (each rank on card LOCAL_RANK, else its rank, modulo the cards), gloo
    on the CPU."""
    import torch
    import torch.distributed as dist

    backend = "nccl" if device == "cuda" else "gloo"
    if args.coordinator:
        if args.num_processes is None or args.process_id is None:
            raise SystemExit("--coordinator needs --num-processes and --process-id")
        dist.init_process_group(backend, init_method=f"tcp://{args.coordinator}",
                                world_size=args.num_processes, rank=args.process_id)
    else:
        dist.init_process_group(backend, init_method="env://")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())


def main(argv=None):
    args = parse_args(argv)
    import torch

    from .device import resolve_device

    device = args.platform
    resolve_device(device)  # raises without a card unless --platform cpu
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    if args.multihost:
        init_multihost(args, device)

    ns = runpy.run_path(args.model)
    if "model" not in ns:
        sys.exit(f"{args.model} must define a `model = ModelParameters(...)`")
    model = ns["model"]
    if args.format:
        model = model.with_(options={**model.opts(), "output_format": args.format})

    available = torch.cuda.device_count() if device == "cuda" else 1
    shards = args.devices if args.devices is not None else (None if args.multihost else 1)
    print(
        f"Initializing {model.equation_set} on {available} available device(s), "
        f"using {shards if shards is not None else 'the group'}"
        + (" (torch.distributed)" if args.multihost else ""), flush=True)
    t0 = time.time()
    if args.multihost or shards > 1:
        from .parallel.sharding import integrate_sharded

        integrate_sharded(
            model,
            shards,
            dtype,
            method=args.shard_method,
            interface=args.shard_interface,
            resume_from=args.resume_from,
            profile_dir=args.profile_dir,
            device=device,
        )
    else:
        from . import integrate_model

        integrate_model(
            model,
            dtype=dtype,
            resume_from=args.resume_from,
            profile_dir=args.profile_dir,
            device=device,
        )
    print(f"All done! ({time.time() - t0:.1f}s)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
