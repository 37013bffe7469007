"""tests/test_bf02_published.py's gate on the port: the Bryan & Fritsch
(2002) saturated moist bubble (scythe_tpu_torch.examples.
bf02_moist_benchmark) at the JAX test's Delta = 208 m point (32 cells x 40
levels, ts 0.25 s, 1000 s), float64 on the CPU, held to its bands: the
initial theta_rho' bubble +2 K (1.8-2.1, |min| < 0.15, w 0), w_max after
1000 s in 9.1-12.4 m/s (the JAX package read 10.76), and theta_e's
extrema within 1 K of their initial range.
"""

import numpy as np
import torch

import scythe_tpu_torch as tx
from scythe_tpu_torch import model as tmodel
from scythe_tpu_torch.examples import bf02_moist_benchmark as bf

torch.set_num_threads(2)


def test_bf02_wmax_converging_to_published(tmp_path):
    """test_bf02_published.py:38."""
    model = bf.build_model(str(tmp_path), num_cells=32, zdim=40, ts=0.25, t_end=1000.0)
    grid = tx.create_grid(model.grid_params, torch.float64, device="cpu")
    bf.write_ics(model, grid, tmodel.build_context(model, grid, torch.float64).ref_state)
    _, _, rows = bf.simulate(model, torch.float64, "cpu", report_every=1000.0)
    (t0, (w0, tmx0, tmn0, te_lo0, te_hi0)), (t1, (wm, tmx, tmn, te_lo, te_hi)) = rows
    assert (t0, t1) == (0.0, 1000.0)
    assert 1.8 < tmx0 < 2.1 and abs(tmn0) < 0.15 and w0 == 0.0
    assert 9.1 < wm < 12.4, wm
    assert te_lo > te_lo0 - 1.0, (te_lo, te_lo0)
    assert te_hi < te_hi0 + 1.0, (te_hi, te_hi0)
