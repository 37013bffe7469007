"""The ensemble smoother on the port: scythe_tpu_torch.examples.
assimilate_enkf against the JAX example's functions, and the outcome gates
of tests/test_enkf.py on the port.

Float64 on the CPU, the two-layer TC twin experiment at 32 cells x 32, 32
members (as tests/test_enkf.py), their 60-step forecasts one batched
integration (torch.func.vmap).  The smoother is forward only: the sampled
ensemble within 1e-12 and the analysis within 1e-9 of the JAX example's.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

_spec = importlib.util.spec_from_file_location(
    "assimilate_enkf_example_for_port",
    os.path.join(os.path.dirname(__file__), "..", "examples", "assimilate_enkf.py"))
enkf_j = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(enkf_j)

from scythe_tpu_torch.examples import assimilate_enkf as enkf  # noqa: E402

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def enkf_run():
    """32 members, as tests/test_enkf.py; the JAX example's analysis too."""
    _, grid, sim, truth0, bg = enkf.build_case(device="cpu")
    xa, X0 = enkf.assimilate(grid, sim, bg, truth0, n_members=32)
    _, gj, simj, tj, bj = enkf_j.build_case()
    xa_j = np.asarray(enkf_j.assimilate(gj, simj, bj, tj, n_members=32))
    X0_j = np.asarray(enkf_j.sample_ensemble(gj, bj, 32))
    return sim, truth0, bg, xa, X0, xa_j, X0_j


def test_enkf_analysis_matches_jax(enkf_run):
    _, _, _, xa, X0, xa_j, X0_j = enkf_run
    assert _rel(X0.numpy(), X0_j) <= 1e-12
    assert _rel(xa, xa_j) <= 1e-9


def test_enkf_reduces_ic_error(enkf_run):
    _, truth0, bg, xa, _, _, _ = enkf_run
    v = enkf.OBS_VAR
    assert enkf.rms(xa[v], truth0[v]) < 0.8 * enkf.rms(bg[v], truth0[v])


def test_enkf_improves_forecast(enkf_run):
    sim, truth0, bg, xa, _, _, _ = enkf_run
    v = enkf.OBS_VAR
    with torch.no_grad():
        fc_t, fc_b, fc_a = (sim({}, x)[v] for x in
                            (truth0, bg, torch.from_numpy(np.ascontiguousarray(xa))))
    assert enkf.rms(fc_a, fc_t) < 0.7 * enkf.rms(fc_b, fc_t)
