#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (scythe_tpu_torch) on one NVIDIA
Hopper GPU.

    python3 chip_smoke.py   # from the root of a checkout; one card

Phases, each printing PASS, its wall time and its numbers on a line:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, and the TF32 switches (both off, float32 matmul precision
   "highest");
2. build: the CUDA kernels from scythe_tpu_torch/ops/csrc with nvcc;
3. kernel against its plain PyTorch version on the card: the AI2* column
   solve for nz in {24, 40, 48, 100}, ncols in {37, 9216} and both stages,
   f64 kernel vs f64 plain (1e-12 of max|ref|) and f32 kernel vs f64 plain
   (1e-5 of max|ref|), then kernel and plain timed at 9216 x 48 f32 with
   CUDA events, in turns (plain, kernel, kernel, plain);
4. main path at full width: integrate_model on the moist3d configuration
   (MoistEulerRLZ, semi-implicit, 48 cells x 64 azimuths x 48 levels,
   9 vars, ts 0.15 s) on "cuda" in f32, 120 steps with output every 60;
   the kernel must have run exactly once a step, the fields stay finite, the
   warm bubble rises (w.max() > 0.01) and three CSV outputs exist; then
   steps/s timed on the card after a warm-up, and a torch.profiler pass
   over 10 steps (device busy time and kernel launches a step; the kernel
   table goes to chiprun_out/moist3d_profile.txt);
5. port parity on the card: a small configuration 20 steps CUDA f64 (kernel)
   against CPU f64 (plain), 1e-9 of each field's max|ref|; moist3d 20 steps
   CUDA f32 against CUDA f64, 1e-4 of each field's max|f64|.

No phase catches its own failure: any failed check raises and the script
exits non-zero.  Without a CUDA device it exits 2 and prints no result.
The last two lines of standard output are a JSON object describing the
kernels, then {"ok": true, "device": {...}}.  It imports nothing of jax.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MOIST3D_VARS = ("s", "xi", "mu", "u", "v", "w", "mu_c", "mu_r", "qss")


def say(phase, t0, msg):
    print(f"PASS {phase} ({time.perf_counter() - t0:.2f} s): {msg}", flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def write_sounding(path):
    zs = np.linspace(0.0, 12000.0, 40)
    theta = 300.0 + 0.004 * zs
    qv = 14.0 * np.exp(-zs / 2500.0)
    with open(path, "w") as f:
        f.write(f"1015.0 {theta[0]} {qv[0]}\n")
        for z, th, q in zip(zs[1:], theta[1:], qv[1:]):
            f.write(f"{z} {th} {q}\n")


def moist_model(tx, tmp, name, *, cells, ldim, xmax, zdim, ts, n_steps, out_every,
                bubble):
    """A MoistEulerRLZ configuration with its sounding and bubble IC CSV
    written under ``tmp``.  ``bubble`` = (x0, z0, radius, amplitude) of the
    cos^2 entropy bubble at azimuth 0."""
    import torch
    from scythe_tpu_torch import io as sio

    gp = tx.GridParameters(
        geometry="RLZ", xmin=0.0, xmax=xmax, num_cells=cells, lDim=ldim,
        zmin=0.0, zmax=10000.0, zDim=zdim,
        BCL={"u": tx.BC.R1T0, "v": tx.BC.R1T0, "w": tx.BC.R1T1},
        BCR={"u": tx.BC.R1T0, "v": tx.BC.R0},
        vars={v: i + 1 for i, v in enumerate(MOIST3D_VARS)},
    )
    snd = os.path.join(tmp, f"{name}_sounding.txt")
    ics = os.path.join(tmp, f"{name}_ics.csv")
    write_sounding(snd)
    pts = tx.create_grid(gp, torch.float64).gridpoints()
    r, lam, z = pts[:, 0], pts[:, 1], pts[:, 2]
    x0, z0, rad0, amp = bubble
    rad = np.sqrt(((r * np.cos(lam) - x0) / rad0) ** 2
                  + (r * np.sin(lam) / rad0) ** 2 + ((z - z0) / rad0) ** 2)
    cols = np.zeros((len(r), 3 + len(MOIST3D_VARS)))
    cols[:, :3] = pts
    cols[:, 3] = amp * np.maximum(0.0, np.cos(np.pi * np.minimum(rad, 1.0) / 2.0)) ** 2
    sio._write_csv(ics, ["r", "l", "z", *MOIST3D_VARS], cols)
    return tx.ModelParameters(
        ts=ts, integration_time=n_steps * ts, output_interval=out_every * ts,
        equation_set="MoistEulerRLZ", initial_conditions=ics,
        output_dir=os.path.join(tmp, f"{name}_out"), ref_state_file=snd,
        grid_params=gp, physical_params={"K": 10.0, "f": 5.0e-5},
        options={"semiimplicit": True},
    )


def moist3d(tx, tmp, n_steps, out_every, name="moist3d"):
    """The JAX package's moist3d benchmark configuration (bench.py
    moist3d_model, its bubble from moist3d_bench)."""
    return moist_model(tx, tmp, name, cells=48, ldim=64, xmax=20000.0, zdim=48,
                       ts=0.15, n_steps=n_steps, out_every=out_every,
                       bubble=(6000.0, 2500.0, 2000.0, 2.0))


def small(tx, tmp, n_steps):
    """tests/test_rlz_tcbl.py's bubble on the small port-test grid."""
    return moist_model(tx, tmp, "small", cells=8, ldim=16, xmax=10000.0, zdim=16,
                       ts=0.25, n_steps=n_steps, out_every=n_steps,
                       bubble=(4000.0, 2000.0, 1500.0, 3.0))


def cuda_time_ms(fn, n):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def per_field_rel(got, ref):
    """max|got - ref| / max|ref| per leading-axis field (fields whose ref is
    identically zero are compared absolutely and reported as such)."""
    out = []
    for v in range(ref.shape[0]):
        scale = np.abs(ref[v]).max()
        err = np.abs(got[v].astype(np.float64) - ref[v]).max()
        out.append(err / scale if scale > 0 else err)
    return out


def phase_kernel(torch, tti, cs, pxi):
    """Phase 3; returns (max_abs_err, ms, plain_ms) at 9216 x 48 f32."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    ts = 0.15
    worst = {"f64": 0.0, "f32": 0.0}
    main_err = None
    for nz in (24, 40, 48, 100):
        o64 = tti.build_semiimplicit_ops(nz, 0.0, 10000.0, None, pxi, ts, torch.float64, "cuda")
        o32 = tti.build_semiimplicit_ops(nz, 0.0, 10000.0, None, pxi, ts, torch.float32, "cuda")
        for ncols in (37, 9216):
            x = torch.from_numpy(rng.normal(size=(ncols, nz))).cuda()
            w = torch.from_numpy(rng.normal(size=(ncols, nz))).cuda()
            for stage, ts_term in (("t1", 0.5 * ts), ("ab", 1.25 * ts)):
                h64, h32 = (o64.hinv_t1, o32.hinv_t1) if stage == "t1" else (o64.hinv, o32.hinv)
                ops64 = (o64.col_filter, o64.col_deriv, h64, o64.synth, o64.dsynth)
                ops32 = (o32.col_filter, o32.col_deriv, h32, o32.synth, o32.dsynth)
                ref = cs.fused_column_solve_plain(x, w, *ops64, ts_term, pxi)
                k64 = cs.fused_column_solve(x, w, *ops64, ts_term, pxi)
                k32 = cs.fused_column_solve(x.float(), w.float(), *ops32, ts_term, pxi)
                torch.cuda.synchronize()
                for got64, got32, r in zip(k64, k32, ref):
                    scale = float(r.abs().max())
                    e64 = float((got64 - r).abs().max())
                    e32 = float((got32.double() - r).abs().max())
                    assert torch.isfinite(got32).all() and torch.isfinite(got64).all()
                    assert e64 <= 1e-12 * scale, (nz, ncols, stage, "f64", e64, scale)
                    assert e32 <= 1e-5 * scale, (nz, ncols, stage, "f32", e32, scale)
                    worst["f64"] = max(worst["f64"], e64 / scale)
                    worst["f32"] = max(worst["f32"], e32 / scale)
                    if nz == 48 and ncols == 9216 and stage == "ab":
                        main_err = max(main_err or 0.0, e32)
    say("kernel-vs-plain", t0,
        f"nz {{24,40,48,100}} x ncols {{37,9216}} x 2 stages; max rel err "
        f"f64 {worst['f64']:.3e} (tol 1e-12), f32 vs f64 {worst['f32']:.3e} (tol 1e-5)")

    # timing at the main path's shape, f32: plain, kernel, kernel, plain
    t0 = time.perf_counter()
    nz, ncols = 48, 9216
    o32 = tti.build_semiimplicit_ops(nz, 0.0, 10000.0, None, pxi, ts, torch.float32, "cuda")
    ops = (o32.col_filter, o32.col_deriv, o32.hinv, o32.synth, o32.dsynth)
    x = torch.from_numpy(rng.normal(size=(ncols, nz))).float().cuda()
    w = torch.from_numpy(rng.normal(size=(ncols, nz))).float().cuda()

    def plain():
        cs.fused_column_solve_plain(x, w, *ops, 1.25 * ts, pxi)

    def kernel():
        cs.fused_column_solve(x, w, *ops, 1.25 * ts, pxi)

    for fn in (plain, kernel):  # warm-up
        cuda_time_ms(fn, 20)
    times = {"plain": [], "kernel": []}
    for name, fn in (("plain", plain), ("kernel", kernel), ("kernel", kernel), ("plain", plain)):
        times[name].append(cuda_time_ms(fn, 200))
    ms, plain_ms = min(times["kernel"]), min(times["plain"])
    say("kernel-timing", t0,
        f"9216 x 48 f32, 200 calls a run: kernel {times['kernel']} ms, plain "
        f"{times['plain']} ms a call (min {ms:.5f} vs {plain_ms:.5f})")
    return main_err, ms, plain_ms


def main():
    t0 = time.perf_counter()
    # the port must need neither jax nor the JAX package: importing fails
    sys.modules["jax"] = None
    sys.modules["scythe_tpu"] = None
    import torch

    if not torch.cuda.is_available():
        print("FAIL environment: torch.cuda.is_available() is false; "
              "chip_smoke.py needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import scythe_tpu_torch as tx
    from scythe_tpu_torch import model as tmodel
    from scythe_tpu_torch import timeintegration as tti
    from scythe_tpu_torch.ops import _build
    from scythe_tpu_torch.ops import column_solve as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    card = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(card, flush=True)
    say("environment", t0,
        f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{count} device(s); TF32 off (matmul, cudnn), f32 matmul precision highest")

    t0 = time.perf_counter()
    built = _build.load()
    assert built.lib.scythe_column_solve_max_nz() == cs.MAX_NZ
    ptxas = [ln.strip() for ln in built.log.splitlines() if "registers" in ln or "spill" in ln]
    say("build", t0,
        f"{built.path.name} in {built.seconds:.2f} s (nvcc); " + " | ".join(ptxas))

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        model = moist3d(tx, tmp, n_steps=120, out_every=60)
        ref = tmodel.build_context(
            model, tx.create_grid(model.grid_params, torch.float64), torch.float64
        ).ref_state
        pxi = float(ref.Pxi_bar)
        main_err, ms, plain_ms = phase_kernel(torch, tti, cs, pxi)

        # ---- phase 4: the main path, counts reset just before it
        t0 = time.perf_counter()
        cs.launches = 0
        grid, phys = tx.integrate_model(model, dtype=torch.float32, device="cuda")
        launches = cs.launches
        assert launches == model.num_ts == 120, launches
        assert phys.shape == (9, 144, 64, 48) and np.isfinite(phys).all()
        wmax = float(phys[MOIST3D_VARS.index("w")].max())
        assert wmax > 0.01, wmax
        outs = sorted(f for f in os.listdir(model.output_dir) if f.startswith("physical_out_"))
        assert len(outs) == 3, outs
        say("main-path", t0,
            f"integrate_model moist3d f32 on cuda, 120 steps: kernel launches "
            f"{launches}, all fields finite, w.max {wmax:.4f} m/s, outputs {outs}")

        t0 = time.perf_counter()
        grid, ctx, state = tmodel.initialize(model, torch.float32, "cuda")
        step = tmodel.build_step(model, grid, ctx, torch.float32)
        for _ in range(10):  # warm-up (and the Euler/AB2 ramp)
            state = step(state)
        torch.cuda.synchronize()
        n = 100
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        for _ in range(n):
            state = step(state)
        end.record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - h0
        ms_step = start.elapsed_time(end) / n
        assert torch.isfinite(state.spec).all()
        say("steps-per-second", t0,
            f"moist3d f32, {n} steps after 10 warm-up: {1000.0 / ms_step:.2f} steps/s "
            f"({ms_step:.4f} ms/step by CUDA events; {n / host_s:.2f} steps/s by host "
            f"clock) on {card}")
        t0 = time.perf_counter()
        from torch.profiler import ProfilerActivity, profile as tprof

        torch.cuda.synchronize()
        with tprof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            h0 = time.perf_counter()
            for _ in range(10):
                state = step(state)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - h0) * 1e6
        avg = prof.key_averages()
        # device rows only: an aten op's row repeats its kernels' time
        kernels = [e for e in avg
                   if e.self_device_time_total > 0 and e.self_cpu_time_total == 0]
        busy_us = sum(e.self_device_time_total for e in kernels)
        table = avg.table(sort_by="self_device_time_total", row_limit=40)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "moist3d_profile.txt"), "w") as f:
            f.write(f"{card}\n10 steps of moist3d f32, host wall {wall_us:.1f} us "
                    f"(profiled), device busy {busy_us:.1f} us\n{table}\n")
        say("profile", t0,
            f"10 steps: device busy {busy_us / 10:.1f} us/step of {wall_us / 10:.1f} "
            f"us/step wall (profiled), {sum(e.count for e in kernels) / 10:.0f} "
            f"kernel launches/step; table in chiprun_out/moist3d_profile.txt")
        del state, step, ctx, grid

        # ---- phase 5: parity on the card
        t0 = time.perf_counter()
        sm = small(tx, tmp, 20)
        _, p_gpu = tx.integrate_model(sm, dtype=torch.float64, device="cuda",
                                      write_outputs=False)
        _, p_cpu = tx.integrate_model(sm, dtype=torch.float64, device="cpu",
                                      write_outputs=False)
        rel_small = per_field_rel(p_gpu, p_cpu)
        assert max(rel_small) <= 1e-9, rel_small
        m20 = moist3d(tx, tmp, n_steps=20, out_every=20, name="moist3d_20")
        _, p32 = tx.integrate_model(m20, dtype=torch.float32, device="cuda",
                                    write_outputs=False)
        _, p64 = tx.integrate_model(m20, dtype=torch.float64, device="cuda",
                                    write_outputs=False)
        rel_m3d = per_field_rel(p32, p64)
        checked = [v for v in range(9) if np.abs(p64[v]).max() > 0.0]
        assert all(rel_m3d[v] <= 1e-4 for v in checked), rel_m3d
        say("parity", t0,
            "small 20 steps cuda f64 vs cpu f64, rel err per field "
            + json.dumps(dict(zip(MOIST3D_VARS, [float(f"{e:.3e}") for e in rel_small])))
            + " (tol 1e-9); moist3d 20 steps cuda f32 vs cuda f64 "
            + json.dumps(dict(zip(MOIST3D_VARS, [float(f"{e:.3e}") for e in rel_m3d])))
            + f" (tol 1e-4 on fields {[MOIST3D_VARS[v] for v in checked]})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(json.dumps({"kernels": [{
        "name": "fused_column_solve",
        "route": "cuda",
        "source": "scythe_tpu_torch/ops/csrc/column_solve.cu",
        "replaces": "scythe_tpu/ops/pallas_semiimplicit.py:118",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
