"""Model driver: build the step and run the time loop, in PyTorch.

The counterpart of ``scythe_tpu.model``.  Per step: synthesis -> pointwise
tendencies -> AB3/AI2* update -> (semi-implicit column solve) ->
(condensation adjustment) -> analysis.  Where the JAX package runs the
steps between outputs inside one jitted ``lax.scan``, here ``make_scan``
replays one CUDA graph of the steady step on the card (``graphs.py``;
``disable_graphs()`` runs the eager loop); the host touches data only at
output boundaries (CSV write + NaN watchdog), the reference cadence
(semiimplicit.jl:288-293).

Every option of the JAX package's build_step and run loop is ported:
``semiimplicit`` (``si_mode`` 'constant' or 'variable'), ``si_scale``,
the radial and top sponges (``sponge_width``, ``sponge_tau``,
``sponge_top_width``, ``sponge_top_tau``, ``sponge_top_vars``), the
radiation boundary (``radiation_width``, ``radiation_speed``), the modal
filter (``modal_filter_tau``, ``modal_filter_order``, ``modal_filter_axes``),
``incremental_analysis``, ``surface_fluxes``, ``implicit_vdiff`` (with
``vdiff_exclude``), and the equation-set hooks (``reference_quirks``,
``exact_vertical_pgf``, ``stiff_relaxation``, ``condensation``,
``condensation_rate_cap``, ``condensation_tau``, ``sedimentation``,
``smagorinsky``, ``smagorinsky_axes``), ``topography_file``,
``checkpoint_interval``, ``write_spectral`` and ``output_format='nc'``.
``profile_dir`` on ``integrate_model`` writes a ``torch.profiler`` trace
and times the captured step's stages.  ``trace.py`` is the registry of the
run loop's spans and counters and of the step's stages.
``integrate_ensemble`` runs members as a leading axis (the step under
``torch.func.vmap`` on a member-batched state, replayed as one graph: each
hand-written kernel launches once a step for all members), on one device or
split over the shards of an ensemble mesh.
``build_step`` takes the sharded builder's transforms and filter
(``analysis_fn``, ``synthesis_fn``, ``modal_filter_fn``) and ``run_loop``
its layout hooks (``to_canonical``, ``from_canonical``, ``gather``): the
radial domain decomposition lives in ``parallel/``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time as _time
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from . import graphs
from . import io as sio
from . import timeintegration as ti
from . import trace
from .basis import bspline, chebyshev
from .config import ModelParameters
from .device import DEFAULT
from .equations.common import EqContext, get_equation_set
from .graphs import disable_graphs  # noqa: F401  (the counterpart of jax.disable_jit)
from .grids.base import Grid, _split3, create_grid
from .physics import microphysics as mp
from .physics import reference_state as rsmod
from .physics import thermodynamics as td

log = logging.getLogger("scythe_tpu_torch")

_NEEDS_CONDENSATION = (
    "BF02_test",
    "rainfall_test",
    "MoistEulerRLZ",
    "MoistEulerXYZ",
    "MoistEulerSLZ",
)


def build_context(model: ModelParameters, grid: Grid, dtype) -> EqContext:
    ref = rsmod.build_reference_state(model, grid, dtype)
    return EqContext(
        grid=grid,
        coords=grid.coords(),
        params=model.phys(),
        options=model.opts(),
        ts=model.ts,
        var_index=grid.params.var_index,
        ref_state=ref,
    )


def infer_radiation_speed(params: dict, opts: dict) -> float:
    """Outgoing-wave speed for the Sommerfeld radiation strip:
    options['radiation_speed'] if set, else sqrt(g H) from the physical
    params (H or Hfree)."""
    rad_c = opts.get("radiation_speed")
    if rad_c is None:
        g_ = params.get("g")
        H_ = params.get("H", params.get("Hfree"))
        if g_ is None or H_ is None:
            raise ValueError(
                "options['radiation_width'] needs options['radiation_speed'] "
                "or physical params g and H/Hfree to infer the gravity-wave "
                "speed"
            )
        rad_c = float(np.sqrt(float(g_) * float(H_)))
    return float(rad_c)


def _second_difference(n: int, periodic: bool) -> np.ndarray:
    d2 = np.zeros((n, n))
    for i in range(n) if periodic else range(1, n - 1):
        d2[i, i] = -2.0
        d2[i, (i - 1) % n] = 1.0
        d2[i, (i + 1) % n] = 1.0
    return d2


def build_modal_filter(grid: Grid, tau: float, order: int, ts: float, dtype,
                       axes: str = "rlz"):
    """Per-step scale-selective modal damping in coefficient space
    (``scythe_tpu.model.build_modal_filter``): exact exponential damping
    with e-folding time ``tau`` at the grid scale, falling as (scale
    fraction)^order toward the resolved scales.

    * B-spline radial axis, per variable: F_v = Q V exp(-(ts/tau) lam/lam_max)
      V^T Q^T, Q an orthonormal basis of the variable's BC-constraint
      subspace range(T_v) and (lam, V) the eigendecomposition of the
      coefficient fourth-difference energy restricted to it, so the filter
      cannot move the state off its boundary conditions.  A periodic
      variable is filtered in its n-dim periodic coefficient space by the
      circulant operator and lifted as T F pinv(T).
    * Where the grid's ring mask depends on r (RL, RLZ, SL, SLZ) the radial
      factor is applied ring-masked and factored: synthesis pre-composed
      with F_v, the mask in (ring, k) space, re-analysis.  XYZ's uniform
      mask commutes with the x mixing, so there F_v applies directly.
    * Fourier axis: exp(-(ts/tau) (|k|/kmax)^order) per wavenumber;
      Chebyshev axis: exp(-(ts/tau) (n/nmax)^order) per mode.

    Every operator is built in float64 numpy and cast once (on a
    compensated grid into its bf16 stack, applied by ``grid._mm``).  ``axes``
    (options['modal_filter_axes']) selects the filtered directions; without
    "r" the radial factor is skipped.  Returns a function spec -> spec."""
    p = grid.params
    g = grid._struct
    a = ts / tau

    def tensor(o):
        return torch.as_tensor(np.asarray(o), dtype=dtype, device=grid.device)

    def prep(o):
        """An operator of grid._mm: on a compensated grid its bf16 stack."""
        if grid.comp:
            return _split3(o).to(dtype=dtype, device=grid.device)
        return tensor(o)

    br = p.b_rDim
    F_r = F_rk = None
    if "r" in axes:
        fs = []
        for v in range(p.nvars):
            T = bspline.constraint_matrix(p.num_cells, p.BCL[v], p.BCR[v])
            if p.BCL[v] == bspline.BC.PERIODIC:
                d2 = _second_difference(p.num_cells, periodic=True)
                lam, vec = np.linalg.eigh(d2.T @ d2)
                core = (
                    vec * np.exp(-a * np.clip(lam / lam.max(), 0.0, None))
                ) @ vec.T
                fs.append(T @ core @ np.linalg.pinv(T))
                continue
            q, _ = np.linalg.qr(T)
            b = _second_difference(br, periodic=False) @ q
            lam, vec = np.linalg.eigh(b.T @ b)
            lmax = lam.max()
            if lmax <= 0.0:
                fs.append(q @ q.T)
                continue
            core = (vec * np.exp(-a * np.clip(lam / lmax, 0.0, None))) @ vec.T
            fs.append(q @ core @ q.T)
        F_r = prep(np.stack(fs))
        if grid.ring_mask is not None:
            mask = grid.ring_mask.detach().cpu().numpy().astype(np.float64)
            if not np.allclose(mask, mask[0][None, :]):
                a_ops, sf_ops = [], []
                for v in range(p.nvars):
                    ops = bspline.build_ops(
                        p.xmin, p.xmax, p.num_cells, p.BCL[v], p.BCR[v], p.l_q
                    )
                    a_ops.append(ops.analysis)  # [b_r, rDim]
                    sf_ops.append(ops.synth[0] @ fs[v])  # [rDim, b_r]
                F_rk = (prep(np.stack(a_ops)), prep(np.stack(sf_ops)), tensor(mask))
                F_r = None

    f_l = f_z = None
    if g in ("RL", "RLZ") and "l" in axes:
        k = grid.slot_wavenumbers()  # dense or factored slot layout
        kmax = max(k.max(), 1.0)
        f_l = tensor(np.exp(-a * (k / kmax) ** order))
    if g in ("RZ", "RLZ") and "z" in axes:
        n = np.arange(p.zDim, dtype=np.float64)
        nmax = max(p.zDim - 1, 1)
        f_z = tensor(np.exp(-a * (n / nmax) ** order))

    def apply(spec):
        out = spec
        if F_r is not None:
            out = grid._mm("vab,vb...->va...", F_r, out)
        elif F_rk is not None:
            A_st, SF_st, mk = F_rk
            if g == "RL":
                mid = grid._mm("vrb,vbk->vrk", SF_st, out) * mk[None]
                out = grid._mm("vbr,vrk->vbk", A_st, mid)
            else:
                mid = grid._mm("vrb,vbkK->vrkK", SF_st, out) * mk[None, :, :, None]
                out = grid._mm("vbr,vrkK->vbkK", A_st, mid)
        if g == "RL" and f_l is not None:
            out = out * f_l[None, None, :]
        elif g == "RZ" and f_z is not None:
            out = out * f_z[None, None, :]
        elif g == "RLZ":
            if f_l is not None:
                out = out * f_l[None, None, :, None]
            if f_z is not None:
                out = out * f_z[None, None, None, :]
        return out

    return apply


def build_surface_fluxes(grid: Grid, ctx: EqContext, cfg: dict, dtype):
    """Bulk-aerodynamic air-sea fluxes (``scythe_tpu.model.
    build_surface_fluxes``): options['surface_fluxes'] = {'sst': K,
    'Ck': 1.2e-3, 'Cd': 1.5e-3, 'depth': 600.0, 'wind_floor': 1.0}.

    Enthalpy and moisture fluxes Ck |U| (x_sea* - x_air) toward the
    saturated sea-surface state at the SST, and momentum drag -Cd |U| u,
    evaluated at the lowest level and deposited over an exp(-z/depth)
    profile of unit column integral on the model levels.  The sea-surface
    state comes from the reference state's surface pressure, on the host in
    float64.  Returns apply(expdot, phys) -> expdot, which adds into
    ``expdot`` in place (the step hands it the tendency the equation set
    made this step, which nothing else holds yet)."""
    p = grid.params
    vi = p.var_index
    rs = ctx.ref_state
    if rs is None:
        raise ValueError("options['surface_fluxes'] requires a ref_state_file")
    for need in ("s", "mu", "u"):
        if need not in p.vars:
            raise ValueError(
                f"options['surface_fluxes'] needs variable {need!r} "
                f"(moist Euler family); got {list(p.vars)}"
            )
    sst = float(cfg["sst"])
    ck = float(cfg.get("Ck", 1.2e-3))
    cd = float(cfg.get("Cd", 1.5e-3))
    depth = float(cfg.get("depth", 600.0))
    floor = float(cfg.get("wind_floor", 1.0))

    z = np.asarray(grid.z_mish, np.float64)
    wz = np.exp(-(z - z[0]) / depth)
    trapz = getattr(np, "trapezoid", None) or np.trapz
    wz = torch.as_tensor(wz / trapz(wz, z), dtype=dtype, device=grid.device)

    def host(x):
        return torch.tensor(float(x), dtype=torch.float64)

    sbar0, xibar0, mubar0 = (float(a[0, 0]) for a in (rs.sbar, rs.xibar, rs.mubar))
    _, rho0, _, p0 = td.thermodynamic_tuple(host(sbar0), host(xibar0), host(mubar0))
    q_star = float(td.q_sat_liquid(host(sst), p0))
    s_star = float(td.entropy(host(sst), rho0, host(q_star)))

    i_s, i_mu, i_u = vi("s"), vi("mu"), vi("u")
    i_v = vi("v") if "v" in p.vars else None

    def apply(expdot, phys):
        u1 = phys[i_u][..., 0]
        spd2 = u1 * u1 + floor * floor
        if i_v is not None:
            v1 = phys[i_v][..., 0]
            spd2 = spd2 + v1 * v1
        spd = torch.sqrt(spd2)
        s1 = phys[i_s][..., 0] + sbar0
        mu1 = phys[i_mu][..., 0] + mubar0
        q1 = td.ahyp(mu1)
        f_s = ck * spd * (s_star - s1)
        f_mu = ck * spd * (q_star - q1) * td.dmudq(mu1, q1)
        expdot[i_s] += f_s[..., None] * wz
        expdot[i_mu] += f_mu[..., None] * wz
        expdot[i_u] += (-cd * spd * u1)[..., None] * wz
        if i_v is not None:
            expdot[i_v] += (-cd * spd * v1)[..., None] * wz
        return expdot

    return apply


@contextlib.contextmanager
def _linalg_library(name: str):
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library(name)
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def batched_solve(m, rhs):
    """X with m X = rhs for a batch of small systems, by LU with partial
    pivoting (LAPACK's getrf on the CPU), without ``solve``'s check of the
    factorisation's ``info``, which waits for the card: a singular system
    gives non-finite fields, which the run loop's watchdog reports.  On the
    card the LU is cuBLAS's batched getrf: the default for these sizes,
    MAGMA's, waits for the host too, so neither could be captured in a CUDA
    graph."""
    if m.device.type != "cuda":
        return torch.linalg.solve_ex(m, rhs)[0]
    with _linalg_library("cusolver"):  # batched: cuBLAS getrf / getrs
        return torch.linalg.solve_ex(m, rhs)[0]


def build_implicit_vdiff(grid: Grid, dtype, exclude=("xi", "qss")):
    """Backward-Euler implicit vertical diffusion (``scythe_tpu.model.
    build_implicit_vdiff``).  Every K-diffused variable phi solves, per
    column, after the explicit and semi-implicit update,

        (I + ts W^-1 D^T diag(w_q K_v) D) phi^{n+1} = phi*

    the symmetric flux form of -d/dz(K d/dz): D the unconstrained spectral
    derivative on the Gauss points, w_q the Chebyshev-Gauss quadrature
    weights, K_v the closure field the equation set returns
    (``EqResult.k_v``).  The [nz, nz] systems are assembled batched over all
    columns and solved with ``torch.linalg.solve_ex`` (the JAX package also
    leaves this solve to its linear-algebra library), the diffused
    variables as shared right-hand sides (``batched_solve``).

    ``exclude`` names the variables left out (xi and qss are not
    K-diffused, as in the equation sets' Laplacian mask;
    options['vdiff_exclude']).  A bare string names one variable; the JAX
    package's ``tuple(exclude)`` splits it into characters."""
    p = grid.params
    if isinstance(exclude, str):
        exclude = (exclude,)
    for name in exclude:
        if name not in p.vars:
            raise ValueError(
                f"options['vdiff_exclude'] names unknown variable "
                f"{name!r} (vars: {list(p.vars)})"
            )
    nz = p.zDim
    z0 = chebyshev.build_ops(nz, p.zmin, p.zmax, p.b_zDim)
    d_r0 = z0.dsynth @ (z0.constrain @ z0.analysis)
    theta = np.pi * (np.arange(nz) + 0.5) / nz
    wq = 0.5 * (p.zmax - p.zmin) * (np.pi / nz) * np.sin(theta)

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=grid.device)

    dmat, wq_t, winv = dev(d_r0), dev(wq), dev(1.0 / wq)
    idxs = tuple(v for v, name in enumerate(p.vars) if name not in exclude)
    eye = torch.eye(nz, dtype=dtype, device=grid.device)

    def apply(var_np1, k_v, ts):
        # k_v: [*spatial] (z last); writes the diffused rows of var_np1 in
        # place (the step's own new tensor) and returns it
        s = torch.einsum("mi,...m,mj->...ij", dmat, wq_t * k_v, dmat)
        m = eye + ts * (winv[:, None] * s)
        rhs = torch.stack([var_np1[i] for i in idxs], dim=-1)
        sol = batched_solve(m, rhs)
        for k, i in enumerate(idxs):
            var_np1[i] = sol[..., k]
        return var_np1

    return apply


def build_step(model: ModelParameters, grid: Grid, ctx: EqContext, dtype,
               analysis_fn=None, synthesis_fn=None, modal_filter_fn=None):
    """Returns step(state) -> state.

    ``analysis_fn`` / ``synthesis_fn`` default to the grid's transforms; the
    sharded builder (``parallel.sharding``) passes a shard's synthesis and a
    sharded analysis (project, psum, solve; or the halo path's distributed
    solve), and the equation set's own refits take them too
    (``EqContext.analysis``).  ``modal_filter_fn`` replaces the per-step
    modal filter built from the options: the sharded builder passes one
    that knows its spectral layout (the halo path's windowed blocks)."""
    if analysis_fn is not None or synthesis_fn is not None:
        ctx = dataclasses.replace(ctx, analysis_fn=analysis_fn, synthesis_fn=synthesis_fn)
    analysis_fn = analysis_fn or grid.analysis
    synthesis_fn = synthesis_fn or grid.synthesis
    eqset = get_equation_set(model.equation_set)
    if getattr(eqset, "geometry", None) and eqset.geometry != grid.geometry:
        raise ValueError(
            f"equation_set {model.equation_set!r} requires a "
            f"{eqset.geometry} grid, got {grid.geometry}"
        )
    opts = ctx.options
    if opts.get("topography_file") and "hs_grad" not in ctx.extras:
        raise ValueError(
            "options['topography_file'] is set but ctx.extras['hs_grad'] is "
            "missing: the context was built without _set_topography "
            "(initialize() calls it)"
        )
    p = grid.params
    semiimplicit = bool(opts.get("semiimplicit"))
    needs_condensation = model.equation_set in _NEEDS_CONDENSATION
    si_ops = None
    if semiimplicit:
        if ctx.ref_state is None:
            raise ValueError("semiimplicit integration requires a ref_state_file")
        si_mode = opts.get("si_mode", "constant")
        if si_mode not in ("constant", "variable"):
            raise ValueError(
                f"options['si_mode'] must be 'constant' or 'variable', "
                f"got {si_mode!r}"
            )
        si_scale = float(opts.get("si_scale", 1.0))
        si_ops = ti.build_semiimplicit_ops(
            p.zDim,
            p.zmin,
            p.zmax,
            p.b_zDim,
            si_scale * np.asarray(ctx.ref_state.Pxi_prof.cpu(), np.float64)
            if si_mode == "variable"
            else si_scale * float(ctx.ref_state.Pxi_bar),
            model.ts,
            dtype,
            grid.device,
        )
        w_i = p.var_index("w")
        xi_i = p.var_index("xi")

    ts = model.ts

    # optional Rayleigh sponge over the outer ``sponge_width`` meters toward
    # the filtered initial state (ctx.extras['sponge_ref']), cos^2 ramp,
    # timescale ``sponge_tau``
    sponge_sigma = sponge_ref = None
    sp_w = float(opts.get("sponge_width", 0.0) or 0.0)
    if sp_w > 0.0:
        tau = float(opts.get("sponge_tau", 600.0))
        ramp = torch.clamp((ctx.coords["r"] - (p.xmax - sp_w)) / sp_w, 0.0, 1.0)
        # [1, *spatial]: sigma carries the variable axis from here on
        sponge_sigma = (torch.sin(0.5 * np.pi * ramp) ** 2 / tau).to(dtype)[None]

    # optional top (z) Rayleigh sponge over the top ``sponge_top_width``
    # meters, timescale ``sponge_top_tau``, on all variables or on
    # ``sponge_top_vars`` only; adds to the radial sponge, same reference
    sp_tw = float(opts.get("sponge_top_width", 0.0) or 0.0)
    if sp_tw > 0.0:
        if "z" not in ctx.coords:
            raise ValueError(
                "options['sponge_top_width'] needs a vertical axis "
                f"(geometry {p.geometry!r} has none)"
            )
        tau_t = float(opts.get("sponge_top_tau", 600.0))
        ramp_t = torch.clamp((ctx.coords["z"] - (p.zmax - sp_tw)) / sp_tw, 0.0, 1.0)
        sigma_t = (torch.sin(0.5 * np.pi * ramp_t) ** 2 / tau_t).to(dtype)[None]
        sp_vars = opts.get("sponge_top_vars")
        if sp_vars is not None:
            mask = torch.zeros((grid.nvars,) + (1,) * (sigma_t.ndim - 1),
                               dtype=dtype, device=grid.device)
            for name in sp_vars:
                mask[p.var_index(name)] = 1.0
            sigma_t = sigma_t * mask
        sponge_sigma = sigma_t if sponge_sigma is None else sponge_sigma + sigma_t
    if sponge_sigma is not None:
        if "sponge_ref" not in ctx.extras:
            raise ValueError(
                "options['sponge_width'] / ['sponge_top_width'] need "
                "ctx.extras['sponge_ref'] (the filtered initial state); "
                "initialize() sets it"
            )
        sponge_ref = ctx.extras["sponge_ref"]

    # optional Sommerfeld (radiating) outer boundary: over the outer
    # ``radiation_width`` meters the tendency blends toward the one-way wave
    # equation d(phi')/dt = -c d(phi')/dr on the perturbation from the
    # filtered initial state
    rad_blend = rad_ref_dr = rad_c = None
    rad_w = float(opts.get("radiation_width", 0.0) or 0.0)
    if rad_w > 0.0:
        rad_c = infer_radiation_speed(ctx.params, opts)
        ramp = torch.clamp((ctx.coords["r"] - (p.xmax - rad_w)) / rad_w, 0.0, 1.0)
        rad_blend = (torch.sin(0.5 * np.pi * ramp) ** 2).to(dtype)[None]
        if "radiation_ref_dr" not in ctx.extras:
            raise ValueError(
                "options['radiation_width'] needs ctx.extras['radiation_ref_dr'] "
                "(d/dr of the filtered initial state); initialize() sets it"
            )
        rad_ref_dr = ctx.extras["radiation_ref_dr"]

    modal_filter = modal_filter_fn
    mf_tau = float(opts.get("modal_filter_tau", 0.0) or 0.0)
    if modal_filter is None and mf_tau > 0.0:
        modal_filter = build_modal_filter(
            grid, mf_tau, int(opts.get("modal_filter_order", 4)), ts, dtype,
            axes=str(opts.get("modal_filter_axes", "rlz")),
        )

    # options['incremental_analysis']: close the step with spec + A(delta)
    # instead of A(var_np1), so only the step's increment passes through the
    # analysis round trip
    incremental = bool(opts.get("incremental_analysis", False))

    sfx_apply = None
    sfx_cfg = opts.get("surface_fluxes")
    if sfx_cfg:
        sfx_apply = build_surface_fluxes(grid, ctx, dict(sfx_cfg), dtype)

    vdiff_apply = None
    if opts.get("implicit_vdiff"):
        if model.equation_set not in ("MoistEulerRLZ", "MoistEulerXYZ", "MoistEulerSLZ"):
            raise ValueError(
                "options['implicit_vdiff'] is supported by the MoistEuler* "
                f"equation sets, not {model.equation_set!r}"
            )
        vdiff_apply = build_implicit_vdiff(
            grid, dtype, opts.get("vdiff_exclude", ("xi", "qss"))
        )

    def step(state: ti.ModelState) -> ti.ModelState:
        with trace.stage("synthesis"):
            fields = synthesis_fn(state.spec)
        with trace.stage("tendency"):
            res = eqset(fields, ctx)
            phys = fields["val"]
            if res.overrides:
                phys = phys.clone()  # fields["val"] is a view of a synthesis buffer
                for v, arr in res.overrides.items():
                    phys[v] = arr
        expdot = res.expdot
        with trace.stage("options"):
            if sfx_apply is not None:
                expdot = sfx_apply(expdot, phys)
            if rad_blend is not None:
                rad_dot = -rad_c * (fields["dr"] - rad_ref_dr)
                expdot = (1.0 - rad_blend) * expdot + rad_blend * rad_dot
            if sponge_sigma is not None:
                expdot = expdot - sponge_sigma * (phys - sponge_ref)
        with trace.stage("update"):
            var_np1, e_nm1, e_nm2 = ti.explicit_step(
                phys, expdot, state.expdot_nm1, state.expdot_nm2, state.t, ts
            )
        # var_np1 is a new tensor made by explicit_step, held by no history
        # and saved by no backward, so the corrector and the vertical
        # diffusion write rows into it in place (the condensation adjustment,
        # whose thermodynamics save views of it, returns a new one); the
        # histories (state.*, res.expdot, res.impdot) are only ever handed on
        impdot = res.impdot
        i_nm1, i_nm2 = state.impdot_nm1, state.impdot_nm2
        # slim implicit history: [[w, xi], *spatial]
        slim = (
            state.impdot_nm1.shape[0] == 2
            and state.impdot_nm1.shape != state.expdot_nm1.shape
        )
        if slim and not semiimplicit:
            raise ValueError(
                "slim impdot history (imp_rows=2) requires "
                "options['semiimplicit'] — use full-width initial_state"
            )
        with trace.stage("semiimplicit"):
            if semiimplicit:
                hw, hx = (0, 1) if slim else (w_i, xi_i)
                w_new, xi_new = ti.semiimplicit_adjustment(
                    si_ops,
                    var_np1[w_i],
                    var_np1[xi_i],
                    impdot[w_i],
                    state.impdot_nm1[hw],
                    state.impdot_nm2[hw],
                    impdot[xi_i],
                    state.impdot_nm1[hx],
                    state.impdot_nm2[hx],
                    state.t,
                )
                var_np1[w_i] = w_new
                var_np1[xi_i] = xi_new
            if impdot is not None:
                i_n = torch.stack([impdot[w_i], impdot[xi_i]]) if slim else impdot
                i_nm1, i_nm2 = i_n, state.impdot_nm1
        with trace.stage("vdiff"):
            if vdiff_apply is not None:
                var_np1 = vdiff_apply(var_np1, res.k_v, ts)
        with trace.stage("condensation"):
            if needs_condensation:
                var_np1 = mp.condensation_adjustment(var_np1, impdot, ctx)
        with trace.stage("analysis"):
            if incremental:
                # the delta is taken against the synthesis value itself, not the
                # override-patched phys, for A(S spec) = spec to cancel
                spec_new = state.spec + analysis_fn(var_np1 - fields["val"])
            else:
                spec_new = analysis_fn(var_np1)
        with trace.stage("filter"):
            if modal_filter is not None:
                spec_new = modal_filter(spec_new)
        return ti.ModelState(
            spec=spec_new,
            expdot_nm1=e_nm1,
            expdot_nm2=e_nm2,
            impdot_nm1=i_nm1,
            impdot_nm2=i_nm2,
            t=state.t + 1,
        )

    return step


def make_scan(step, n_steps: int):
    """``step`` applied ``n_steps`` times: the counterpart of
    ``scythe_tpu.model.make_scan``, which compiles the steps between two
    outputs into one scan.  On the card the start-up steps (t = 1, 2) run
    eagerly and the steady step as replays of one CUDA graph, captured once
    for the step and its state layout and kept on the step
    (``graphs.scan``); on the CPU, under ``disable_graphs()``, under grad
    or a functorch transform, and for sharded steps, a loop of eager
    steps.  The returned state shares no storage with the graph."""

    def chunk(state):
        return graphs.scan(step, n_steps, state)

    return chunk


def imp_history_rows(model: ModelParameters) -> int | None:
    """Implicit-history width for ti.initial_state: the slim 2-row [w, xi]
    layout for semi-implicit configurations, full width otherwise."""
    return 2 if model.opts().get("semiimplicit") else None


def initialize(model: ModelParameters, dtype=None, device: Any = DEFAULT):
    """Build grid, context and initial state from the IC file on ``device``
    (the card unless the caller asks for the CPU; ref initialize_model,
    semiimplicit.jl:126-193)."""
    dtype = dtype or torch.get_default_dtype()
    grid = create_grid(model.grid_params, dtype, device=device)
    ctx = build_context(model, grid, dtype)
    phys0 = sio.read_physical_grid(model.initial_conditions, grid)
    spec0 = grid.analysis(torch.as_tensor(phys0, dtype=dtype, device=grid.device))
    _set_boundary_refs(ctx, grid, spec0)
    _set_topography(ctx, grid)
    state = ti.initial_state(
        spec0,
        (grid.nvars,) + grid.spatial_shape,
        dtype,
        imp_rows=imp_history_rows(model),
    )
    return grid, ctx, state


def _set_topography(ctx, grid):
    """Bottom topography for the spherical shallow-water set
    (``scythe_tpu.model._set_topography``): ``options['topography_file']``
    names a CSV in the IC schema (coordinate columns, then ``hs``) on this
    grid's points.  Its spectrally filtered gradient [d/dlat, d/dlon] goes
    into ctx.extras['hs_grad'] and its filtered value into
    ctx.extras['hs_filtered']."""
    topo = ctx.options.get("topography_file")
    if not topo:
        return
    names, data = sio._read_csv(topo)
    if "hs" not in names:
        raise ValueError(f"topography file {topo} needs an 'hs' column")
    if data.shape[0] != grid.num_points:
        raise ValueError(
            f"topography file {topo} has {data.shape[0]} rows; grid has "
            f"{grid.num_points} points"
        )
    pad = np.zeros((grid.nvars,) + grid.spatial_shape)
    pad[0] = data[:, names.index("hs")].reshape(grid.spatial_shape)
    f = grid.synthesis(grid.analysis(
        torch.as_tensor(pad, dtype=grid.dtype, device=grid.device)))
    ctx.extras["hs_grad"] = torch.stack([f["dr"][0], f["dl"][0]])
    ctx.extras["hs_filtered"] = f["val"][0].clone()


def _set_boundary_refs(ctx, grid, spec0):
    """Reference extras for the sponges and the radiation boundary: both
    relax toward / radiate against the *filtered* initial state, what the
    spline space represents, not the raw ICs (``scythe_tpu.model.
    _set_boundary_refs``)."""
    need_sponge = (
        float(ctx.options.get("sponge_width", 0.0) or 0.0) > 0.0
        or float(ctx.options.get("sponge_top_width", 0.0) or 0.0) > 0.0
    )
    need_rad = float(ctx.options.get("radiation_width", 0.0) or 0.0) > 0.0
    if not (need_sponge or need_rad):
        return
    fields0 = grid.synthesis(spec0)
    if need_sponge:
        ctx.extras["sponge_ref"] = fields0["val"].clone()
    if need_rad:
        ctx.extras["radiation_ref_dr"] = fields0["dr"].clone()


def integrate_model(
    model: ModelParameters,
    dtype=None,
    write_outputs=True,
    resume_from: str | None = None,
    profile_dir: str | None = None,
    device: Any = DEFAULT,
):
    """Public driver (ref integrate_model, src/Scythe.jl:37-62).

    Runs ``integration_time / ts`` steps on ``device`` (the card unless the
    caller asks for the CPU; raises without a card), writing CSV (or, with
    options['output_format']='nc', NetCDF) output and running the NaN
    watchdog every ``output_interval`` (plus t=0 and the final time).
    options['checkpoint_interval'] (seconds) writes full-state checkpoints
    in the JAX package's ``.npz`` layout beside the output, and
    ``resume_from`` restarts from one bitwise.  ``profile_dir`` wraps the
    run in a ``torch.profiler`` trace written there (``logged_run``).  Returns (grid, final
    physical values [nvars, *spatial] as a numpy array)."""
    dtype = dtype or torch.get_default_dtype()
    with logged_run(model, profile_dir):
        t_setup = _time.time()
        grid, ctx, state = initialize(model, dtype, device)
        step = build_step(model, grid, ctx, dtype)
        return run_loop(
            model, grid, ctx, state, step, dtype,
            write_outputs=write_outputs, resume_from=resume_from,
            t_setup=t_setup,
        )


class logged_run:
    """Context manager: the ``scythe_out.log`` file handler in the output
    directory for the duration of a run and, with ``profile_dir``, a
    ``torch.profiler`` trace of it (the host, and the card where there is
    one), written to ``profile_dir/trace.json`` in the Chrome trace
    format, with the stages of a captured step timed by CUDA events inside
    its graph (``trace.stage_times``; their means close the log, the
    profiler's own cost on each kernel inside them)."""

    def __init__(self, model: ModelParameters, profile_dir: str | None = None):
        self.model = model
        self.profile_dir = profile_dir
        self.handler = None
        self._prof = None

    def __enter__(self):
        if _primary():  # rank 0 writes the log of a torch.distributed run
            os.makedirs(self.model.output_dir, exist_ok=True)
            self.handler = logging.FileHandler(
                os.path.join(self.model.output_dir, "scythe_out.log")
            )
            log.addHandler(self.handler)
        log.setLevel(logging.INFO)
        if self.profile_dir:
            from torch._C._profiler import _ExperimentalConfig
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._stages = trace.stage_times()
            self._stages.__enter__()
            # every thread: the output writer's ranges too
            self._prof = profile(activities=acts, experimental_config=_ExperimentalConfig(
                profile_all_threads=True))
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            self._stages.__exit__(*exc)
            os.makedirs(self.profile_dir, exist_ok=True)
            self._prof.export_chrome_trace(os.path.join(self.profile_dir, "trace.json"))
        if self.handler is not None:
            log.removeHandler(self.handler)
            self.handler.close()
        return False


def _primary() -> bool:
    """Whether this process writes a run's files: rank 0 of an initialised
    torch.distributed group, or the only process."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def run_loop(
    model: ModelParameters,
    grid,
    ctx,
    state,
    step,
    dtype,
    *,
    write_outputs=True,
    resume_from=None,
    t_setup=None,
    to_canonical=None,
    from_canonical=None,
    gather=None,
):
    """The output/checkpoint/watchdog time loop (ref run_model + model_loop,
    src/semiimplicit.jl:219-293).  Checkpoints (options['checkpoint_interval'],
    seconds) are written at output boundaries whose step count is a multiple
    of it, named ``checkpoint_<t>.npz`` as the JAX package names them, so
    either package resumes from the other's.

    ``integrate_sharded`` passes ``gather`` (a sharded tensor to the whole
    tensor, ``parallel.sharding.gather_global``), ``to_canonical`` (the
    gathered spectral state to the canonical coefficient array, e.g. from
    the halo path's windowed blocks) and ``from_canonical`` (a canonical
    state onto the shards), so outputs and checkpoints stay canonical and a
    sharded run resumes from a single-device checkpoint and the other way
    round.  In a torch.distributed run every rank gathers and rank 0 writes
    the files.

    The output write runs behind the next interval (``_WriteBehind``): at
    each boundary this thread fetches the fields (and, with
    ``write_spectral``, the coefficients) to the host and runs the watchdog,
    waits for the previous output's write, hands this output's host arrays
    to the call's one writer thread and enqueues the next interval.  The
    writer touches no device tensor.  Checkpoints stay on this thread.  When
    the call returns or raises, every output it handed over is on disk in
    order; a write's exception is raised here with its own type, at the next
    hand-off or at the end.

    Tracing (``trace.py``; a run record a call, ``trace.last_run()``): the
    span ``run_loop`` over the call; at each output boundary the spans
    ``run_loop.fetch`` (gather, synthesis, the copy to the host),
    ``run_loop.watchdog``, ``run_loop.write_wait`` (this thread's wait for
    the previous write before the hand-off), ``run_loop.write`` on the
    writer thread (with the counter ``output_bytes``, each file's size) and
    ``run_loop.checkpoint``; for each interval ``run_loop.interval`` (the
    host's enqueue of its steps) and ``run_loop.drain`` (the host's wait for
    an event recorded after its last replay).  On the card the counter
    ``boundary_idle_s`` is the card's idle at each interior boundary on its
    own clock: from the event after one interval's last replay to one
    recorded before the next interval's first work, read at the next drain,
    when both are done.  Nothing waits for the card inside an interval."""
    t_setup = t_setup or _time.time()
    t_sim0 = 0.0
    if resume_from:
        state, t_sim0 = sio.load_checkpoint(resume_from, dtype, grid.device)
        if from_canonical is not None:
            state = from_canonical(state)
        log.info("Resumed from %s at t=%s (step %d)", resume_from, t_sim0, state.t)
    num_ts = model.num_ts
    output_int = max(1, min(model.output_int, num_ts))
    log.info(
        "Initialized %s on %s grid: %d vars, %s points, %d steps, %s",
        model.equation_set,
        grid.geometry,
        grid.nvars,
        grid.spatial_shape,
        num_ts,
        grid.device,
    )

    gather = gather or (lambda x: x)
    write_outputs = write_outputs and _primary()

    def canonical_spec(st):
        spec = gather(st.spec)
        if to_canonical is not None:
            spec = to_canonical(spec)
        return spec.to(grid.device)

    def canonical(st):
        return st._replace(
            spec=canonical_spec(st),
            **{k: gather(getattr(st, k)) for k in
               ("expdot_nm1", "expdot_nm2", "impdot_nm1", "impdot_nm2")},
        )

    ckpt_interval = ctx.options.get("checkpoint_interval", 0.0)
    ckpt_int = int(round(ckpt_interval / model.ts)) if ckpt_interval else 0
    write_spec = bool(ctx.options.get("write_spectral"))

    def fetch(st, write):
        """The physical fields on the host and, where they are written, a
        host copy of the canonical spectral state (the next interval
        overwrites the state's own tensors); every rank gathers them, as a
        gather on a DistMesh is a collective."""
        spec = canonical_spec(st)
        phys = grid.synthesis(spec)["val"].cpu().numpy()
        return phys, spec.detach().to("cpu", copy=True) if write and write_spec else None

    def write_files(t_sim, phys, spec):
        """The writer thread's job: the output files of one boundary."""
        with trace.span("run_loop.write"):
            paths = [sio.write_output(grid, model, t_sim, phys)]
            if spec is not None:
                paths.append(sio.write_spectral(grid, model, t_sim, spec))
        for path in paths:
            trace.count("output_bytes", os.path.getsize(path))

    on_card = torch.device(grid.device).type == "cuda"

    def event():
        """A timing event on the card's current stream, or None on the CPU."""
        if not on_card:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(grid.device))
        return ev

    def output(st, t_sim, writer, watch=True, write=True):
        """This thread's side of an output boundary: fetch, watchdog, and the
        hand-off of the write."""
        with trace.span("run_loop.fetch"):
            phys, spec = fetch(st, write)
        if watch:
            with trace.span("run_loop.watchdog"):
                sio.check_cfl(grid, phys)
        if write:
            writer.submit(write_files, t_sim, phys, spec)
        return phys

    with trace.run() as rec, trace.span("run_loop"), _WriteBehind() as writer:
        first = write_outputs and not resume_from
        phys = output(state, t_sim0, writer, watch=first, write=first)
        log.info("Setup in %.2fs; starting integration", _time.time() - t_setup)
        steps_done = 0
        prev_end = None  # the event after the previous interval's last replay
        while steps_done < num_ts:
            n = min(output_int, num_ts - steps_done)
            start = event()
            with trace.span("run_loop.interval"):
                state = make_scan(step, n)(state)
            end = event()
            with trace.span("run_loop.drain"):
                if end is not None:
                    end.synchronize()
            if prev_end is not None:  # the card's idle at the boundary, its own clock
                trace.count("boundary_idle_s", 1e-3 * prev_end.elapsed_time(start))
            prev_end = end
            for name, sec in graphs.stage_seconds(step).items():
                trace.count(f"stage_s.{name}", sec)
            steps_done += n
            t_sim = t_sim0 + steps_done * model.ts
            phys = output(state, t_sim, writer, write=write_outputs)
            if ckpt_int and steps_done % ckpt_int == 0:
                with trace.span("run_loop.checkpoint"):
                    ckpt_state = canonical(state)
                    if _primary():
                        path = os.path.join(model.output_dir,
                                            f"checkpoint_{round(t_sim, 2)}.npz")
                        sio.save_checkpoint(path, ckpt_state, t_sim)
                        log.info("checkpoint: %s", path)
            log.info("ts: %s", t_sim)
    _log_run(rec, num_ts, grid.num_points)
    return grid, phys


class _WriteBehind:
    """One background writer for a ``run_loop`` call, at most one write in
    flight: ``submit`` waits for the previous job (the span
    ``run_loop.write_wait``, raising its exception) and hands the next to the
    thread.  Leaving the block, whether it raised or not, waits for the last
    job, so every file handed over is on disk.  That job's exception is
    raised where the block ends normally; where the block raises (the
    watchdog's FloatingPointError, say), its own exception goes on, with the
    job's in a note."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="run_loop.writer")
        self._pending = None

    def __enter__(self):
        return self

    def submit(self, fn, *args):
        with trace.span("run_loop.write_wait"):
            self._wait()
        self._pending = self._pool.submit(fn, *args)

    def _wait(self):
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def __exit__(self, exc_type, exc, tb):
        try:
            self._wait()
        except Exception as err:
            if exc is None:
                raise
            exc.add_note(f"the pending output write failed too: {err!r}")
        finally:
            self._pool.shutdown()
        return False


def _log_run(rec, num_ts: int, num_points: int):
    """The closing lines of ``scythe_out.log``, from the run record: steps/s
    over the whole ``run_loop`` (the initial output and every boundary
    included), an output boundary's mean parts (the write on the writer
    thread, ``write_wait`` this thread's wait for it) and the bytes written;
    where the run captured its steady step, the graph's nodes by stage; where the
    stages were timed, each stage's mean device time of the intervals' last
    replays."""
    wall = rec.total("run_loop")
    rate = num_ts / wall if wall > 0 else float("inf")

    def ms(name):
        mean = rec.mean(name)
        return "-" if mean is None else f"{1e3 * mean:.3f}"

    log.info(
        "Done: %d steps in %.3fs (%.1f steps/s, %.3e grid-point-steps/s, wall clock "
        "incl. output); a boundary, ms: drain %s, fetch %s, watchdog %s, write_wait %s, "
        "write %s (behind the next interval); %d bytes written",
        num_ts, wall, rate, rate * num_points, ms("run_loop.drain"),
        ms("run_loop.fetch"), ms("run_loop.watchdog"), ms("run_loop.write_wait"),
        ms("run_loop.write"), rec.total("output_bytes") or 0)
    nodes = rec.total("graph.nodes")
    if nodes is not None:
        log.info("Graph: %d nodes a step; by stage: %s", nodes, ", ".join(
            f"{name} {rec.total(f'graph.nodes.{name}'):.0f}"
            for name in trace.STAGES + trace.SUBSTAGES
            if rec.total(f"graph.nodes.{name}") is not None))
    staged = [(name, rec.mean(f"stage_s.{name}")) for name in trace.STAGES + trace.SUBSTAGES]
    if any(mean is not None for _, mean in staged):
        log.info("Stage device us a step (the last replay of each interval, mean): %s",
                 ", ".join(f"{name} {1e6 * mean:.2f}" for name, mean in staged
                           if mean is not None))


def batched_step(step):
    """``step`` over a member-batched state: its five tensors carry the
    members as a leading axis and ``t`` stays a host int; the step runs under
    ``torch.func.vmap`` (``t`` closed over, not batched)."""

    def bstep(state: ti.ModelState) -> ti.ModelState:
        def member(*tensors):
            return tuple(step(ti.ModelState(*tensors, state.t))[:5])

        return ti.ModelState(*torch.func.vmap(member)(*state[:5]), state.t + 1)

    return bstep


def ensemble_state(spec, phys_shape, imp_rows: int | None = None) -> ti.ModelState:
    """``ti.initial_state`` of every member: ``spec`` [n, ...] batched
    coefficients, ``phys_shape`` [n, nvars, *spatial]."""
    z = torch.zeros(tuple(phys_shape), dtype=spec.dtype, device=spec.device)
    zi = z
    if imp_rows is not None and imp_rows != phys_shape[1]:
        zi = torch.zeros((phys_shape[0], imp_rows) + tuple(phys_shape[2:]),
                         dtype=spec.dtype, device=spec.device)
    return ti.ModelState(spec, z, z, zi, zi, 1)


def integrate_ensemble(model: ModelParameters, ics, dtype=None, mesh=None,
                       device: Any = DEFAULT):
    """Run an ensemble of initial conditions through the model on ``device``
    (the card unless the caller asks for the CPU).

    ``ics``: [n_members, nvars, *spatial] physical initial conditions.
    Returns (grid, final physical fields [n_members, nvars, *spatial] as a
    numpy array).  The analysis, the step (``batched_step``) and the
    synthesis go under ``torch.func.vmap`` over a member-batched state, so
    the members batch through every transform product, each hand-written
    kernel takes them in one launch a step (its vmap rule folds them into
    its columns or variables), and ``make_scan`` replays the batched
    steady step as one graph on the card, as the JAX package jits the vmap
    of its scan.  As in the JAX package, the context is the model's own
    (no boundary references are set from the members' states).

    ``mesh`` (``parallel.mesh.make_ensemble_mesh``): the members are split
    into ``mesh.size`` blocks in order, each shard runs its block under the
    same vmap on its own device (the mesh's devices take the place of
    ``device``), and the blocks come back in rank order; members are
    independent, so the shards never communicate.  ``n_members`` must be
    divisible by the mesh's size."""
    dtype = dtype or torch.get_default_dtype()
    if mesh is not None and len(ics) % mesh.size:
        raise ValueError(
            f"n_members={len(ics)} must be divisible by the {mesh.size}-shard "
            "ensemble mesh"
        )
    runners = {}

    def runner(dev):
        """(grid, run) on ``dev``, built once a device."""
        if dev not in runners:
            grid = create_grid(model.grid_params, dtype, device=dev)
            ctx = build_context(model, grid, dtype)
            step = batched_step(build_step(model, grid, ctx, dtype))
            scan = make_scan(step, model.num_ts)
            imp_rows = imp_history_rows(model)

            def run(arr):
                with torch.no_grad():
                    state = ensemble_state(torch.func.vmap(grid.analysis)(arr), arr.shape,
                                           imp_rows)
                    spec = scan(state).spec
                    return torch.func.vmap(lambda s: grid.synthesis(s)["val"])(spec)

            runners[dev] = (grid, run)
        return runners[dev]

    arr = torch.as_tensor(np.asarray(ics), dtype=dtype)
    if mesh is None:
        grid, run = runner(torch.device(device))
        out = run(arr.to(grid.device)).cpu().numpy()
    else:
        from .parallel.sharding import Sharded, gather_global

        blocks = arr.chunk(mesh.size)
        devs = [mesh.device_of(r) for r in mesh.local_ranks]
        # built before the shards start, once a device
        runs = [runner(dev)[1] for dev in devs]
        parts = mesh.run(lambda blk, run: run(blk),
                         [blocks[r].to(dev) for r, dev in zip(mesh.local_ranks, devs)], runs)
        grid = runner(devs[0])[0]
        out = gather_global(Sharded(parts, 0, mesh)).cpu().numpy()
    sio.check_cfl(grid, out.reshape((-1,) + grid.spatial_shape))
    return grid, out
