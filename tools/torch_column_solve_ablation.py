#!/usr/bin/env python3
"""Where the PyTorch port's column-solve kernels spend their time, on one
CUDA card: each kernel as it is and built with parts of its work left out
(their results are wrong and discarded), timed in one call beside the
library call and an empty kernel.  A development tool of scythe_tpu_torch;
no main path runs it.

    python3 tools/torch_column_solve_ablation.py [--sweep] [--profile]   # repo root, one card

Variants, each a textual edit of ``scythe_tpu_torch/ops/csrc/column_solve.cu``
built with the flags of ``ops/_build.py`` (the tool stops if an edited line
is no longer in the source).  The plain f32 body, at the moist3d shape
(9216 columns x nz 48) and the TC shape (1200 x 24):

  * as is;
  * 1xTF32: only the hi(a) hi(b) product of each term (a third of the
    tensor-core products);
  * no K loop: the copies, barriers and stores alone;

the comp body (bf16x3 on m16n8k16), at chip_smoke.py phase 27's four shapes
(9216 x 48, 1200 x 24, 2304 x 32, 13,824 x 24):

  * as is;
  * hi·hi only: the lo·hi and hi·lo products left out (a third of them);
  * no K loop: the bulk copies, the split pass, barriers and stores;
  * no split pass: the A tiles left as they are (copies and products);

and, for reference, ``torch.matmul([x* | w*], M^T)`` (the library call, in
true f32) and ``torch.cuda._sleep(1)`` (a launch).  Each is timed as device
time a call (chip_smoke.queued_time_ms: calls queued behind a sleep
kernel), the minimum of two runs of 200 calls.  The card's name and power
limit come first; each shape's line names its plan.

``--sweep`` times the comp body at every plan of a grid (N whole or
halved, 2 or 4 output tiles a warp, three column spans, every row-group
count that fits) at the four shapes and prints the fastest and
``plan_comp``'s choice.  ``--profile`` builds the comp body with clock64
marks (a textual edit as above: the first row-group thread of every group
records its clocks since the block's start) and prints, for
``plan_comp``'s plan at each shape, each phase's median and largest
clocks: set-up to the block's barrier, the first tile landed, the split
pass, the group barrier, M landed, the products, the stores.
"""

from __future__ import annotations

import ctypes
import itertools
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, edits of the source: (text, replacement)) of the plain f32 body
VARIANTS = (
    ("as is", ()),
    ("1xTF32", (("      mma_tf32(lh[P][j], al, b.x, b.y);\n"
                 "      mma_tf32(hl[P][j], ah, b.z, b.w);\n", ""),)),
    ("no K loop", (("      {\n        // two K steps a trip",
                    "      if (false) {\n        // two K steps a trip"),)),
)
# the same of the comp body
COMP_VARIANTS = (
    ("comp as is", ()),
    ("comp hi·hi only", (("        mma_bf16(lh[j], al, b[j].x, b[j].y);\n"
                          "        mma_bf16(hl[j], ah, b[j].z, b[j].w);\n", ""),)),
    ("comp no K loop", (("    for (int ks = 0; ks < L.ks; ++ks) {",
                         "    for (int ks = 0; ks < 0; ++ks) {"),)),
    ("comp no split pass", (("    {  // the split pass:",
                             "    if (false) {  // the split pass:"),)),
)
# the comp body with clock64 marks: slot k of a row group's 16 in g_prof
PROFILE_EDITS = (
    ("// NTW: 8-wide output tiles a warp\ntemplate <int NTW>",
     "__device__ unsigned long long g_prof[264 * 8 * 16];\n"
     "// NTW: 8-wide output tiles a warp\ntemplate <int NTW>"),
    ("  for (int l = rgi; l < ntiles; l += p.rg) ++mine;\n",
     "  for (int l = rgi; l < ntiles; l += p.rg) ++mine;\n"
     "  const long long pf0 = clock64();\n"
     "  auto stamp = [&](int k) {\n"
     "    if (lt == 0) g_prof[(blockIdx.x * 8 + rgi) * 16 + k] = clock64() - pf0;\n"
     "  };\n"),
    ("  __syncthreads();  // the barriers are initialised\n\n  const int qr",
     "  __syncthreads();  // the barriers are initialised\n  stamp(1);\n\n  const int qr"),
    ("    mbar_wait(full, i & 1);  // this tile landed\n",
     "    mbar_wait(full, i & 1);  // this tile landed\n    if (i == 0) stamp(2);\n"),
    ("    group_sync();  // the A tiles are whole; the raw tile is read\n",
     "    if (i == 0) stamp(3);\n"
     "    group_sync();  // the A tiles are whole; the raw tile is read\n"
     "    if (i == 0) stamp(4);\n"),
    ("    if (i == 0) mbar_wait(m_full, 0);\n",
     "    if (i == 0) mbar_wait(m_full, 0);\n    if (i == 0) stamp(5);\n"),
    ("    // the outputs, stored from the registers",
     "    if (i == 0) stamp(6);\n    // the outputs, stored from the registers"),
    ("    if (i + 1 < mine) group_sync();  // the A tiles are read\n  }\n}",
     "    if (i + 1 < mine) group_sync();  // the A tiles are read\n  }\n  stamp(7);\n"
     "  if (lt == 0) g_prof[(blockIdx.x * 8 + rgi) * 16 + 15] = mine;\n}"),
    ("}  // extern \"C\"",
     "int scythe_prof_read(void* dst) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_prof, sizeof(g_prof)));\n}\n"
     "int scythe_prof_zero() {\n"
     "  static unsigned long long z[264 * 8 * 16];\n"
     "  return static_cast<int>(cudaMemcpyToSymbol(g_prof, z, sizeof(z)));\n}\n"
     "}  // extern \"C\""),
)
PROFILE_PHASES = ("set-up", "first tile landed", "split pass", "group barrier", "M landed",
                  "products", "stores and end")
SHAPES = ((9216, 48), (1200, 24))
COMP_SHAPES = ((9216, 48), (1200, 24), (2304, 32), (13824, 24))


def build(_build, tmp: Path, profile: bool) -> dict:
    """One library a variant, all nvcc started together."""
    src = (_build.CSRC / "column_solve.cu").read_text()
    procs = {}
    extra = (("comp profile", PROFILE_EDITS),) if profile else ()
    for name, edits in VARIANTS + COMP_VARIANTS + extra:
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: the kernel source changed")
            text = text.replace(old, new, 1)
        cu = tmp / f"{name.replace(' ', '_').replace('·', '')}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.COMPILE_FLAGS, "-shared", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{out}")
        lib = ctypes.CDLL(str(so))
        lib.scythe_column_solve_f32.argtypes = _build.COLUMN_SOLVE_ARGTYPES
        lib.scythe_column_solve_comp.argtypes = _build.COLUMN_SOLVE_COMP_ARGTYPES
        libs[name] = lib
    return libs


def comp_plans(cs, ncols: int, nz: int) -> list:
    """--sweep's grid of comp plans at this shape (each one plan_comp could
    pick, and spans of twice and half its blocks)."""
    K = 2 * cs._up8(nz)
    quads = cs._cdiv(ncols, 4)
    plans = []
    for nsplit, ntw in itertools.product((1, 2), (2, 4)):
        tg = 32 * cs._cdiv(K // 8 // nsplit, ntw)
        for ranges in sorted({132 // nsplit, 66 // nsplit, 264 // nsplit}):
            span = 4 * cs._cdiv(quads, ranges)
            tiles = cs._cdiv(min(span, ncols), cs.TILE)
            for rg in range(1, min(cs.COMP_MAX_RG, tiles, cs.COMP_MAX_THREADS // tg) + 1):
                smem = cs.comp_smem_bytes(nz, nsplit, rg)
                if smem <= cs.SMEM_MAX:
                    plans.append(cs.CompPlan(span, nsplit, rg, ntw, rg * tg, smem,
                                             nsplit * cs._cdiv(ncols, span)))
    return plans


def profile(torch, lib, call) -> str:
    """One launch of the clock64-marked body; each phase's median and
    largest clocks over the row groups that had a tile."""
    buf = (ctypes.c_ulonglong * (264 * 8 * 16))()
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    lib.scythe_prof_zero()
    call()
    torch.cuda.synchronize()
    lib.scythe_prof_read(ctypes.addressof(buf))
    marks = np.frombuffer(buf, dtype=np.uint64).reshape(-1, 16).astype(np.float64)
    marks = marks[marks[:, 15] > 0]
    phases = np.diff(np.concatenate([np.zeros((len(marks), 1)), marks[:, 1:8]], axis=1))
    return "; ".join(f"{name} {np.median(phases[:, k]):.0f} (max {phases[:, k].max():.0f})"
                     for k, name in enumerate(PROFILE_PHASES))


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true", help="time the comp body at a grid of plans")
    ap.add_argument("--profile", action="store_true", help="the comp body's clock64 marks")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("torch_column_solve_ablation.py needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import nvidia_smi_line, queued_time_ms
    from scythe_tpu_torch import timeintegration as tti
    from scythe_tpu_torch.ops import _build
    from scythe_tpu_torch.ops import column_solve as cs

    print(nvidia_smi_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = build(_build, Path(tmp), args.profile)
        comp_libs = {n: libs.pop(n) for n, _ in COMP_VARIANTS}
        prof_lib = libs.pop("comp profile", None)
        for ncols, nz in SHAPES:
            o = tti.build_semiimplicit_ops(nz, 0.0, 1.0e4, None, 9.0e4, 0.15,
                                           torch.float32, "cuda")
            x = torch.from_numpy(rng.normal(size=(ncols, nz))).float().cuda()
            w = torch.from_numpy(rng.normal(size=(ncols, nz))).float().cuda()
            xw = torch.cat([x, w], dim=1)
            m_t = o.solve.M.T
            w_out, xi_out = torch.empty_like(x), torch.empty_like(x)
            p = cs.plan(ncols, nz, torch.float32)
            calls = {"library": lambda: torch.matmul(xw, m_t),
                     "launch": lambda: torch.cuda._sleep(1)}
            for name, lib in libs.items():
                def call(lib=lib):
                    err = lib.scythe_column_solve_f32(
                        x.data_ptr(), w.data_ptr(), o.solve.packed.data_ptr(),
                        w_out.data_ptr(), xi_out.data_ptr(), ncols, nz, p.rg, p.kslab,
                        p.st, p.threads, p.smem, p.blocks,
                        torch.cuda.current_stream().cuda_stream)
                    if err != 0:
                        raise RuntimeError(f"launch failed ({err})")
                calls[name] = call
            for fn in calls.values():
                for _ in range(20):
                    fn()
            times = {name: min(queued_time_ms(fn, 200) for _ in range(2))
                     for name, fn in calls.items()}
            print(f"{ncols} x {nz} f32, {p}: " + ", ".join(
                f"{name} {t:.5f} ms" for name, t in times.items()), flush=True)
        for ncols, nz in COMP_SHAPES:
            o = tti.build_semiimplicit_ops(nz, 0.0, 1.0e4, None, 9.0e4, 0.15,
                                           torch.float32, "cuda", use_pallas=True)
            x = torch.from_numpy(rng.normal(size=(ncols, nz))).float().cuda()
            w = torch.from_numpy(rng.normal(size=(ncols, nz))).float().cuda()
            xw = torch.cat([x, w], dim=1)
            m_t = o.solve.M.T
            w_out, xi_out = torch.empty_like(x), torch.empty_like(x)
            p = cs.plan_comp(ncols, nz)
            calls = {"library": lambda: torch.matmul(xw, m_t),
                     "launch": lambda: torch.cuda._sleep(1)}
            def launch(lib, q):
                err = lib.scythe_column_solve_comp(
                    x.data_ptr(), w.data_ptr(), o.solve.packed.data_ptr(), w_out.data_ptr(),
                    xi_out.data_ptr(), ncols, nz, q.span, q.nsplit, q.rg, q.ntw, q.threads,
                    q.smem, q.blocks, torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"launch failed ({err}): {q}")

            for name, lib in comp_libs.items():
                calls[name] = lambda lib=lib: launch(lib, p)
            for fn in calls.values():
                for _ in range(20):
                    fn()
            times = {name: min(queued_time_ms(fn, 200) for _ in range(2))
                     for name, fn in calls.items()}
            print(f"{ncols} x {nz} comp, {p}: " + ", ".join(
                f"{name} {t:.5f} ms" for name, t in times.items()), flush=True)
            if prof_lib is not None:
                prof_lib.scythe_prof_read.argtypes = [ctypes.c_void_p]
                print(f"  clock64 marks, median (max) clocks a row group: "
                      + profile(torch, prof_lib, lambda: launch(prof_lib, p)), flush=True)
            if args.sweep:
                lib = comp_libs["comp as is"]
                swept = []
                for q in comp_plans(cs, ncols, nz):
                    fn = lambda q=q: launch(lib, q)  # noqa: E731
                    for _ in range(10):
                        fn()
                    swept.append((min(queued_time_ms(fn, 200) for _ in range(2)), q))
                swept.sort(key=lambda r: r[0])
                chosen = [t for t, q in swept if q == p]
                print(f"  sweep of {len(swept)} plans: plan_comp's {chosen[0]:.5f} ms, the "
                      f"fastest " + "; ".join(f"{t:.5f} ms {q}" for t, q in swept[:3]),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
