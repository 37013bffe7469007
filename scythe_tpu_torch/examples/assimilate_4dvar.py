"""Strong-constraint 4D-Var through the differentiable core, in PyTorch:
the port of ``examples/assimilate_4dvar.py``.

Twin experiment on the two-layer TC model (Twoway_ShallowWater_Slab, the
``cha_bell_initialization.flagship_model`` configuration, 32 cells x 32):
the truth is the Rankine vortex with a wavenumber-2 asymmetry, the
background its azimuthal mean at 75% amplitude, the observations the
free-layer v every 3rd radius x every 2nd azimuth with 0.5 m/s noise at
steps 0, 30 and 60.  The control variable is the increment's spectral
coefficients with a wavenumber-weighted ridge, minimized by Adam on a
cosine-decayed rate (optax.adam and cosine_decay_schedule's arithmetic)
with gradients from ``torch.autograd`` through ``adjoint.make_simulator``.

    python -m scythe_tpu_torch.examples.assimilate_4dvar [--cpu] [--iters 350]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

OBS_STEPS = (0, 30, 60)  # observation times (steps of ts=3 s)
OBS_SIGMA = 0.5  # wind-obs error [m/s]
OBS_VAR = 2  # observe free-layer v
SUBSAMPLE = (slice(None, None, 3), slice(None, None, 2))


def build_case(num_cells=32, nl=32, dtype=torch.float64, device="cuda", remat=True):
    """(model, grid, simulators by observation step, truth, background)."""
    from ..adjoint import make_simulator
    from .cha_bell_initialization import flagship_model, vortex_phys

    model = flagship_model(num_cells, nl)
    sims = {0: (lambda params, x0: x0)}
    grid = None
    for n in OBS_STEPS:
        if n:
            sims[n], grid, _ = make_simulator(model, dtype, n_steps=n, remat=remat,
                                              device=device)
    truth0 = torch.as_tensor(vortex_phys(grid), dtype=dtype, device=grid.device)
    bg = 0.75 * truth0.mean(dim=2, keepdim=True) * torch.ones_like(truth0)
    return model, grid, sims, truth0, bg


def synthesize_obs(sims, truth0, seed=0):
    """The observations at every step of OBS_STEPS, noise from numpy."""
    rng = np.random.default_rng(seed)
    obs = {}
    with torch.no_grad():
        for n in OBS_STEPS:
            v = sims[n]({}, truth0)[OBS_VAR][SUBSAMPLE]
            noise = rng.normal(0.0, OBS_SIGMA, tuple(v.shape))
            obs[n] = v + torch.as_tensor(noise, dtype=v.dtype, device=v.device)
    return obs


def wavenumber_weights(grid, dtype, device):
    k = grid.slot_wavenumbers()  # each spectral slot's, dense or factored
    return torch.as_tensor((1.0 + (k / 2.0) ** 2) ** 1.5, dtype=dtype, device=device)[None, None, :]


def cost_fn(grid, sims, bg, obs, ridge=1e-2):
    """The 4D-Var cost of a spectral increment, and the map to the analysis
    initial state."""
    wk = wavenumber_weights(grid, bg.dtype, bg.device)

    def x0_of(dspec):
        return bg + grid.synthesis(dspec)["val"]

    later = [n for n in OBS_STEPS if n]

    def cost(dspec):
        x0 = x0_of(dspec)
        # the window's fields at every observation time: x0 itself at step
        # 0, the rest from one integration (sims[n] of each n step for step)
        fields = dict(zip(later, sims[later[-1]].fields_at({}, x0, later)))
        fields[0] = x0
        J = sum(
            0.5 * torch.sum((fields[n][OBS_VAR][SUBSAMPLE] - obs[n]) ** 2) / OBS_SIGMA**2
            for n in OBS_STEPS
        )
        return J + 0.5 * torch.sum(wk * dspec**2) * ridge

    return cost, x0_of


def assimilate(grid, sims, bg, obs, iters=350, lr=0.3, ridge=1e-2, history=None):
    """Minimize the cost over the spectral increment; returns (analysis
    initial state, last cost).  ``history``, a list, gets each iterate of
    the increment (before its update) as float64 numpy."""
    from ..adjoint import adam, cosine_decay

    cost, x0_of = cost_fn(grid, sims, bg, obs, ridge)
    d = torch.zeros(grid.spectral_shape, dtype=bg.dtype, device=bg.device, requires_grad=True)
    opt = adam([d], lr)
    sched = cosine_decay(lr, iters)
    J = None
    for i in range(iters):
        if history is not None:
            history.append(d.detach().cpu().numpy().astype(np.float64))
        opt.zero_grad()
        J = cost(d)
        J.backward()
        opt.param_groups[0]["lr"] = sched(i)
        opt.step()
    with torch.no_grad():
        return x0_of(d), float(J)


def rms(a, b):
    a, b = (np.asarray(x.detach().cpu() if torch.is_tensor(x) else x) for x in (a, b))
    return float(np.sqrt(np.mean((a - b) ** 2)))


def wave2_power(f):
    F = np.fft.rfft(np.asarray(f.detach().cpu() if torch.is_tensor(f) else f), axis=1)
    return float((np.abs(F[:, 2]) ** 2).sum())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--iters", type=int, default=350)
    args = ap.parse_args(argv)
    model, grid, sims, truth0, bg = build_case(device="cpu" if args.cpu else "cuda")
    obs = synthesize_obs(sims, truth0)
    x0, J = assimilate(grid, sims, bg, obs, iters=args.iters)
    n_end = OBS_STEPS[-1]
    with torch.no_grad():
        fc_tr, fc_bg, fc_an = (sims[n_end]({}, x)[OBS_VAR] for x in (truth0, bg, x0))
    print(f"J = {J:.1f} after {args.iters} iters\n"
          f"IC v rms error:       {rms(bg[OBS_VAR], truth0[OBS_VAR]):.3f} -> "
          f"{rms(x0[OBS_VAR], truth0[OBS_VAR]):.3f} m/s\n"
          f"forecast v rms error: {rms(fc_bg, fc_tr):.3f} -> {rms(fc_an, fc_tr):.3f} m/s\n"
          f"wave-2 power: truth {wave2_power(truth0[OBS_VAR]):.0f}, background 0, "
          f"analysis {wave2_power(x0[OBS_VAR]):.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
