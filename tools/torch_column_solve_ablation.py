#!/usr/bin/env python3
"""Where the PyTorch port's column-solve kernel spends its time, on one CUDA
card: the kernel as it is and built with parts of its work left out (their
results are wrong and discarded), timed in one call beside the library call
and an empty kernel.  A development tool of scythe_tpu_torch; no main path
runs it.

    python3 tools/torch_column_solve_ablation.py   # from the repo root, one card

Variants, each a textual edit of ``scythe_tpu_torch/ops/csrc/column_solve.cu``
built with the flags of ``ops/_build.py`` (the tool stops if an edited line
is no longer in the source):

  * as is;
  * 1xTF32: only the hi(a) hi(b) product of each term (a third of the
    tensor-core products);
  * no K loop: the copies, barriers and stores alone;

and, for reference, ``torch.matmul([x* | w*], M^T)`` (the library call) and
``torch.cuda._sleep(1)`` (a launch).  Each is timed as device time a call
(chip_smoke.queued_time_ms: calls queued behind a sleep kernel), the minimum
of two runs of 200 calls, at the moist3d shape (9216 columns x nz 48, f32)
and the TC shape (1200 x 24).  The card's name and power limit come first.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, edits of the source: (text, replacement))
VARIANTS = (
    ("as is", ()),
    ("1xTF32", (("      mma_tf32(lh[P][j], al, b.x, b.y);\n"
                 "      mma_tf32(hl[P][j], ah, b.z, b.w);\n", ""),)),
    ("no K loop", (("      {\n        // two K steps a trip",
                    "      if (false) {\n        // two K steps a trip"),)),
)
SHAPES = ((9216, 48), (1200, 24))


def build(_build, tmp: Path) -> dict:
    """One library a variant, all nvcc started together."""
    src = (_build.CSRC / "column_solve.cu").read_text()
    procs = {}
    for name, edits in VARIANTS:
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: the kernel source changed")
            text = text.replace(old, new, 1)
        cu = tmp / f"{name.replace(' ', '_')}.cu"
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
        libs[name] = lib
    return libs


def main() -> int:
    import torch

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
        libs = build(_build, Path(tmp))
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
