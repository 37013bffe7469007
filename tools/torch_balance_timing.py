#!/usr/bin/env python3
"""Where the time of the JW06 production balance goes on the card.

Runs ``balanced_delta`` of scythe_tpu_torch/examples/jw06_baroclinic_slz.py
at its production size (48 cells x 24 levels, nl_solve 4: a dense 6,912 x
6,912 float64 Jacobian, three Newton iterations) on the card, as
chip_smoke.py's phase 20 does, with each truncated-SVD least-squares solve
timed alone; on the first solve it also times cuSOLVER's other SVD drivers
(gesvdj, gesvda) on the same Jacobian and prints how far their solution is
from the default one.

    python3 tools/torch_balance_timing.py

Prints a line a solve, then the balance's total seconds, the solves' share
and the residual history.  Needs a CUDA card.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, ROOT)
    import torch

    import scythe_tpu_torch as tx
    from scythe_tpu_torch import balance
    from scythe_tpu_torch import model as tmodel
    from scythe_tpu_torch.examples import jw06_baroclinic_slz as tw

    lstsq = balance._lstsq
    solves = []

    def timed(J, b, rcond):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = lstsq(J, b, rcond)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        other = {}
        for driver in ("gesvdj", "gesvda") if not solves else ():
            try:
                t0 = time.perf_counter()
                u, s, vh = torch.linalg.svd(J, full_matrices=False, driver=driver)
                mask = s >= rcond * s[0]
                s_inv = torch.where(mask, 1.0 / torch.where(mask, s, torch.ones_like(s)), 0.0)
                xd = vh.T @ (s_inv * (u.T @ b))
                torch.cuda.synchronize()
                other[driver] = {"seconds": time.perf_counter() - t0,
                                 "rel_diff": float((xd - x).abs().max() / x.abs().max())}
            except RuntimeError as e:
                other[driver] = repr(e)[:200]
        solves.append(seconds)
        print(f"lstsq {list(J.shape)}: {seconds:.2f} s; other drivers {other}", flush=True)
        return x

    balance._lstsq = timed
    model = tw.production_model(tempfile.mkdtemp(prefix="balance_timing_"), t_end=75.0,
                                num_cells=48, zdim=24)
    g64 = tx.create_grid(model.grid_params, torch.float64, device="cpu")
    c64 = tmodel.build_context(model, g64, torch.float64)
    t0 = time.perf_counter()
    _, history = tw.balanced_delta(model, g64, c64, device="cuda")
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    print(f"balance {total:.2f} s, of which the solves {sum(solves):.2f} s (with the other "
          f"drivers' first-solve timings); history {history}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
