#!/usr/bin/env python3
"""The comp (bf16x3) RLZ analysis kernel on one card, at every analysis
shape of chip_smoke.py on its own geometry: its error against its plain
version (rlz_analysis_comp_plain) and against the f64 chain beside the
plain version's, two calls bitwise equal, the vmap rule's folded members
within the direct bar of single calls; with --time, its device time beside the plain
version, the library call (one torch.einsum over the chain on O_hi + O_lo,
true f32) and the bound, at chip_smoke.py's timed comp shapes.

    python3 tools/torch_comp_analysis_check.py [--time] [--profile]
        [--stages] [--shapes a,b]

--profile reads the kernel's clock64 marks at the timed shapes (cycles a
block, mean over the grid, consumer warp 0's by phase: waiting for x, the
lambda products, the coefficients' store, the radial stage, its set-up
and its wait at the barrier after the store; the block's main loop,
reduction and vertical stage); --stages first runs each stage
alone with the other operators identities.

Prints ptxas' lines for the kernels, one line a shape and a JSON summary
last; exits 1 if a check fails (every shape is still run)."""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def stages(torch, ra, rng) -> list:
    """Each stage of the comp kernel alone at small shapes: the operators
    of the other stages are identities (bf16-exact: hi 1, lo 0), the ring
    mask ones, so the kernel computes one contraction; its error against
    its plain version."""
    from scythe_tpu_torch.ops.bf16x3 import split_op

    failed = []
    for V, R, L, Z in ((2, 32, 16, 16), (1, 16, 16, 8), (2, 48, 64, 48)):
        x = torch.from_numpy(rng.normal(size=(V, R, L, Z))).float().cuda()
        eye = {n: torch.eye(n, dtype=torch.float64) for n in (R, L, Z)}
        for name in ("none", "lambda", "mask", "radial", "vertical"):
            la = rng.normal(size=(L, L)) if name == "lambda" else eye[L]
            an = rng.normal(size=(V, R, R)) if name == "radial" else eye[R].expand(V, R, R)
            az = rng.normal(size=(V, Z, Z)) if name == "vertical" else eye[Z].expand(V, Z, Z)
            mask = rng.uniform(size=(R, L)) if name == "mask" else np.ones((R, L))
            ops = (split_op(torch.as_tensor(la)), torch.as_tensor(mask),
                   split_op(torch.as_tensor(an)), split_op(torch.as_tensor(az)))
            ops = tuple(o.float().contiguous().cuda() for o in ops)
            k = ra.rlz_analysis(x, *ops, mode="comp")
            ref = ra.rlz_analysis_comp_plain(x, *ops)
            torch.cuda.synchronize()
            err = float((k - ref).abs().max() / ref.abs().max())
            ok = err <= 1e-5
            print(f"stage {name} [{V}, {R}, {L}, {Z}]: {'PASS' if ok else 'FAIL'} rel err "
                  f"{err:.3e}; {ra.plan(x.shape, R, torch.float32, 'comp')}", flush=True)
            if not ok:
                failed.append(f"stage {name} {[V, R, L, Z]}")
    return failed


PROF_SLOTS = ("wait_x", "lambda", "store_a", "radial", "main", "reduce", "vertical",
              "setup", "sync_a")


def profile(torch, ra, lib, x, ops):
    """The comp kernel's clock64 marks for one call (its plan, its packed
    operators): mean cycles over the blocks, by slot, and the block count."""
    V, R, L, Z = x.shape
    B = ops[2].shape[2]
    packed = ra.comp_operators(ops[0], ops[2], ops[3])
    p = ra.plan(x.shape, B, torch.float32, "comp")
    out = torch.empty((V, B, L, Z), dtype=torch.float32, device="cuda")
    prof = torch.zeros((p.ctas, 10), dtype=torch.int64, device="cuda")
    for _ in range(2):  # the second call's marks
        err = lib.scythe_rlz_analysis_comp(
            x.data_ptr(), packed.la.data_ptr(), ops[1].data_ptr(), packed.an.data_ptr(),
            packed.az.data_ptr(), out.data_ptr(), V, R, L, Z, B, packed.nvars, p.kt, p.bt,
            p.c, p.rc, p.rp, p.lc, p.st, p.threads, p.smem,
            torch.cuda.current_stream().cuda_stream, prof.data_ptr())
        assert err == 0, err
    torch.cuda.synchronize()
    mean = prof.double().mean(dim=0).tolist()
    return {k: round(v) for k, v in zip(PROF_SLOTS, mean)}, p.ctas


def launch_plan(torch, ra, lib, x, ops, p, prof=None):
    """One launch of the comp kernel with plan p (its packed operators)."""
    V, R, L, Z = x.shape
    B = ops[2].shape[2]
    packed = ra.comp_operators(ops[0], ops[2], ops[3])
    out = torch.empty((V, B, L, Z), dtype=torch.float32, device="cuda")
    err = lib.scythe_rlz_analysis_comp(
        x.data_ptr(), packed.la.data_ptr(), ops[1].data_ptr(), packed.an.data_ptr(),
        packed.az.data_ptr(), out.data_ptr(), V, R, L, Z, B, packed.nvars, p.kt, p.bt,
        p.c, p.rc, p.rp, p.lc, p.st, p.threads, p.smem,
        torch.cuda.current_stream().cuda_stream, prof)
    assert err == 0, (err, p)
    return out


def sweep(torch, ra, lib, smoke, x, ops):
    """Device ms of the comp kernel under other plans than plan()'s (20
    calls queued behind a sleep kernel): up to 400 of the (kt, bt, c,
    threads, rc, lc) that fit, each with its largest rp and ring; the ten
    fastest printed, plan()'s own first."""
    V, R, L, Z = x.shape
    B = ops[2].shape[2]
    cands = []
    kts = sorted({k for k in (8, 16) if k <= L} | ({L} if L <= 16 else set()))
    bts = sorted({B} | {b for b in range(16, B, 16)})
    for kt, bt, c, threads in itertools.product(kts, bts, range(1, 9), ra.COMP_THREADS):
        rows = ra.comp_slice_rows(R, c)
        if c > 1 and (c - 1) * rows >= R:
            continue
        cap = ra.SMEM_TWO_A_SM if threads == ra.COMP_THREADS[0] else ra.SMEM_MAX
        for rc in sorted({rows} | set(range(16, min(64, rows - 16) + 1, 16))):
            lcs = {lc for lc in (16, 32, 48, 64) if lc <= L} | ({L} if L <= 64 else set())
            for lc in sorted(lcs):
                for rp in range(min(rc, ra.COMP_MAX_RP), 1, -2):
                    if rc % rp or not ra.comp_items_fit(Z, kt, rp, threads):
                        continue
                    for st in (4, 3, 2):
                        smem = ra._comp_smem(Z, R, kt, bt, c, rc, rp, lc, st)
                        if smem <= cap:
                            cands.append(ra.Plan(kt=kt, bt=bt, c=c, rc=rc, rp=rp, lc=lc, zc=Z,
                                                 st=st, threads=threads, smem=smem,
                                                 grid=(c, -(-L // kt) * -(-B // bt), V)))
                            break
                    else:
                        continue
                    break  # the largest rp that fits this (rc, lc)
    rng = np.random.default_rng(len(cands))
    pick = [cands[i] for i in rng.permutation(len(cands))[:400]]
    own = ra.plan(x.shape, B, torch.float32, "comp")
    times = []
    for p in [own] + pick:
        try:
            t = smoke.queued_time_ms(lambda: launch_plan(torch, ra, lib, x, ops, p), 20)
        except AssertionError as e:
            print("  refused", e, flush=True)
            continue
        times.append((t, p))
    print(f"  plan() {own}: {times[0][0]:.5f} ms", flush=True)
    for t, p in sorted(times, key=lambda tp: tp[0])[:10]:
        print(f"  {t:.5f} ms {p}", flush=True)
    return times


def main(argv=None) -> int:
    import torch

    import chip_smoke as smoke
    import scythe_tpu_torch as tx
    from scythe_tpu_torch.ops import _build
    from scythe_tpu_torch.ops import rlz_analysis as ra

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--time", action="store_true", help="time the timed comp shapes")
    ap.add_argument("--shapes", default=",".join(smoke.ANALYSIS_SHAPES),
                    help="comma-separated names of chip_smoke.ANALYSIS_SHAPES")
    ap.add_argument("--sweep", action="store_true",
                    help="time other plans than plan()'s at the timed shapes")
    ap.add_argument("--profile", action="store_true",
                    help="the kernel's clock64 marks at the timed shapes")
    ap.add_argument("--stages", action="store_true",
                    help="first, each stage alone: the other operators identities")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    built = _build.load()
    print("\n".join(ln.strip() for ln in built.log.splitlines()
                    if ln.startswith("==") or "registers" in ln or "spill" in ln
                    or "rlz_analysis_comp" in ln), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    failed, summary = [], {}
    if args.stages:
        failed += stages(torch, ra, rng)
    for name in args.shapes.split(","):
        nv = smoke.ANALYSIS_SHAPES[name][0]
        params = smoke.analysis_params(tx, name)
        g64 = tx.create_grid(params, torch.float64, device="cuda")
        gc = tx.create_grid(params, torch.float32, matmul="compensated", device="cuda")
        ops64 = (g64.l_analysis, g64.ring_mask, g64.analysis_r, g64.analysis_z)
        opsc = (gc.l_analysis, gc.ring_mask, gc.analysis_r, gc.analysis_z)
        x = torch.from_numpy(rng.normal(size=(nv,) + g64.spatial_shape)).cuda()
        x32 = x.float()
        ref = ra.rlz_analysis_plain(x, *ops64)
        plain = ra.rlz_analysis_comp_plain(x32, *opsc)
        try:
            k, kb = (ra.rlz_analysis(x32, *opsc, mode="comp") for _ in range(2))
            torch.cuda.synchronize()
        except RuntimeError as e:
            print(f"{name}: FAIL {e}", flush=True)
            failed.append(name)
            continue
        scale = float(ref.abs().max())
        ek = float((k.double() - ref).abs().max()) / scale
        ep = float((plain.double() - ref).abs().max()) / scale
        ed = float((k.double() - plain.double()).abs().max()) / scale
        finite = bool(torch.isfinite(k).all())
        same = bool(torch.equal(k, kb))
        lo, hi = smoke.COMP_ERR_RATIO
        ok = (finite and same and ed <= smoke.COMP_DIRECT["rlz_analysis"]
              and lo * ep <= ek <= hi * ep and ek <= 1e-4)
        members = None
        if name in ("moist3d", "ragged", "tc"):
            xb = torch.stack([x32, 2.0 * x32 + 1.0])
            fold = torch.func.vmap(lambda p: ra.rlz_analysis(p, *opsc, mode="comp"))(xb)
            one = torch.stack([ra.rlz_analysis(p, *opsc, mode="comp") for p in xb])
            # the folded call may take another plan (V differs), so it sums
            # in another order: held at the direct bar
            members = float((fold - one).abs().max()) / scale
            ok = ok and members <= smoke.COMP_DIRECT["rlz_analysis"]
        p = ra.plan(x.shape, g64.params.b_rDim, torch.float32, "comp")
        # where the kernel and its plain version differ most, by (b, k, z)
        d = (k.double() - plain.double()).abs()
        worst = [int(i) for i in np.unravel_index(int(d.argmax()), tuple(d.shape))]
        print(f"{name} {list(x.shape)} b_rDim {g64.params.b_rDim}: {'PASS' if ok else 'FAIL'} "
              f"rel err vs its plain version {ed:.3e} (at {worst}); vs f64 kernel {ek:.3e}, "
              f"plain {ep:.3e} ({ek / ep:.3f}x); finite {finite}, repeatable {same}, folded "
              f"members rel err {members}; {p} {p.ctas} blocks", flush=True)
        summary[name] = {"direct": ed, "vs_f64": ek, "plain_vs_f64": ep, "ok": ok}
        if not ok:
            failed.append(name)
        if args.time and name in smoke.ANALYSIS_COMP_SHAPES:
            library = smoke.analysis_library(
                torch, x32, ra._unsplit(gc.l_analysis), gc.ring_mask,
                ra._unsplit(gc.analysis_r), ra._unsplit(gc.analysis_z))
            kt, pt, lt = smoke.in_turns(
                lambda: ra.rlz_analysis_comp_plain(x32, *opsc),
                lambda: ra.rlz_analysis(x32, *opsc, mode="comp"), 100,
                timer=smoke.queued_time_ms, library=library)
            bound, by = smoke.analysis_comp_bound(tuple(x.shape), g64.params.b_rDim)
            print(f"  time {name}: kernel {kt} ms, plain {pt} ms, library {lt} ms; bound "
                  f"{bound:.5f} ms ({by}), kernel at {100.0 * bound / min(kt):.1f}%", flush=True)
            summary[name].update(ms=min(kt), plain_ms=min(pt), library_ms=min(lt),
                                 bound_ms=bound)
        if args.sweep and name in smoke.ANALYSIS_COMP_SHAPES:
            print(f"  sweep {name}:", flush=True)
            sweep(torch, ra, built.lib, smoke, x32, opsc)
        if args.profile and name in smoke.ANALYSIS_COMP_SHAPES:
            marks, ctas = profile(torch, ra, built.lib, x32, opsc)
            print(f"  clock64 {name} ({ctas} blocks), mean cycles a block: "
                  f"{json.dumps(marks)}", flush=True)
            summary[name]["clock64"] = marks
    print(smoke.nvidia_smi_line(), flush=True)
    print(json.dumps({"failed": failed, "shapes": summary}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
