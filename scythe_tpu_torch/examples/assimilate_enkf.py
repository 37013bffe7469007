"""Ensemble-smoother data assimilation with batched ensembles, in PyTorch:
the port of ``examples/assimilate_enkf.py``.

The 4D-Var twin experiment (``assimilate_4dvar``) solved with an ensemble
instead of the adjoint: the members' 60-step forecasts run as one batched
integration (``torch.func.vmap`` over ``adjoint.make_simulator``'s run,
the ``model.integrate_ensemble`` execution), and the initial-condition mean
is updated with the gain from initial-time anomalies against
observation-time forecast anomalies (a single-iteration smoother).  The
perturbations come from the 4D-Var's wavenumber-weighted spectral
covariance.

    python -m scythe_tpu_torch.examples.assimilate_enkf [--cpu] [--members 64]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

OBS_SIGMA = 0.5
OBS_VAR = 2
SUB = (slice(None, None, 3), slice(None, None, 2))
N_STEPS = 60


def build_case(num_cells=32, nl=32, dtype=torch.float64, device="cuda"):
    """(model, grid, 60-step simulator, truth, background)."""
    from ..adjoint import make_simulator
    from .cha_bell_initialization import flagship_model, vortex_phys

    model = flagship_model(num_cells, nl)
    sim, grid, _ = make_simulator(model, dtype, n_steps=N_STEPS, device=device)
    truth0 = torch.as_tensor(vortex_phys(grid), dtype=dtype, device=grid.device)
    bg = 0.75 * truth0.mean(dim=2, keepdim=True) * torch.ones_like(truth0)
    return model, grid, sim, truth0, bg


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


def obs_operator(x0, xf):
    """Subsampled v at the analysis time and the window end, stacked."""
    return np.concatenate([_np(x0[OBS_VAR])[SUB].ravel(), _np(xf[OBS_VAR])[SUB].ravel()])


def sample_ensemble(grid, bg, n_members, target_spread=2.0, seed0=100):
    """Background ensemble from the 4D-Var-consistent spectral covariance
    (std ~ w_k^{-1/2}); numpy draws, one generator a member."""
    k = grid.slot_wavenumbers()  # each spectral slot's, dense or factored
    std_k = 1.0 / np.sqrt((1.0 + (k / 2.0) ** 2) ** 1.5)
    d = np.stack([np.random.default_rng(seed0 + i).normal(size=grid.spectral_shape)
                  for i in range(n_members)]) * std_k[None, None, None, :]
    with torch.no_grad():
        perts = torch.func.vmap(lambda s: grid.synthesis(s)["val"])(
            torch.as_tensor(d, dtype=bg.dtype, device=bg.device))
    sc = target_spread / torch.sqrt((perts[:, OBS_VAR] ** 2).mean())
    return bg[None] + sc * perts


def smoother_update(X0, HX, y, sigma=OBS_SIGMA):
    """Update the initial-condition ensemble mean with the gain of (IC
    anomalies) x (observation-space forecast anomalies); numpy float64."""
    n = X0.shape[0]
    X0n = _np(X0).reshape(n, -1)
    x0m = X0n.mean(0)
    A0 = X0n - x0m
    hxm = HX.mean(0)
    Ah = HX - hxm
    S = Ah.T @ Ah / (n - 1) + sigma**2 * np.eye(Ah.shape[1])
    incr = (A0.T @ (Ah @ np.linalg.solve(S, np.asarray(y) - hxm))) / (n - 1)
    return (x0m + incr).reshape(X0.shape[1:])


def forecast(sim, X0):
    """Every member's forecast in one batched integration."""
    with torch.no_grad():
        return torch.func.vmap(lambda x: sim({}, x))(X0)


def assimilate(grid, sim, bg, truth0, n_members=64, seed=0):
    """The analysis initial state (float64 numpy) and the ensemble."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        y0 = obs_operator(truth0, sim({}, truth0))
    y = y0 + rng.normal(0.0, OBS_SIGMA, y0.shape)
    X0 = sample_ensemble(grid, bg, n_members)
    Xf = forecast(sim, X0)
    HX = np.stack([obs_operator(X0[i], Xf[i]) for i in range(n_members)])
    return smoother_update(X0, HX, y), X0


def rms(a, b):
    return float(np.sqrt(np.mean((_np(a) - _np(b)) ** 2)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--members", type=int, default=64)
    args = ap.parse_args(argv)
    model, grid, sim, truth0, bg = build_case(device="cpu" if args.cpu else "cuda")
    xa, _ = assimilate(grid, sim, bg, truth0, n_members=args.members)
    xa_t = torch.as_tensor(xa, dtype=bg.dtype, device=bg.device)
    with torch.no_grad():
        fc_t, fc_b, fc_a = (sim({}, x)[OBS_VAR] for x in (truth0, bg, xa_t))
    print(f"{args.members}-member ensemble smoother:\n"
          f"IC v rms error:       {rms(bg[OBS_VAR], truth0[OBS_VAR]):.3f} -> "
          f"{rms(xa[OBS_VAR], truth0[OBS_VAR]):.3f} m/s\n"
          f"forecast v rms error: {rms(fc_b, fc_t):.3f} -> {rms(fc_a, fc_t):.3f} m/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
