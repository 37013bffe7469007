"""The post-step condensation adjustment as one CUDA kernel for Hopper.

``physics.microphysics.condensation_adjustment`` (ref microphysics.jl:
139-195) is a pointwise map: per point it reads the rows s, xi, mu, the
cloud (mu_c or mu_l), mu_r (where the state has it) and qss of ``var_np1``
and the reference columns sbar, xibar, mubar at the point's level, and
writes new s, mu and cloud.  Its plain PyTorch chain is ~200 elementwise
kernels; in a captured step of the mature TC each is a graph node of
~1.3 us at 28,800 points.  The kernel, ``ops/csrc/condensation.cu``, is the
whole map in one launch, one thread a point, in place in ``var_np1``'s
rows.  It replaces no TPU kernel: the JAX package leaves the map to XLA's
fusion, which makes it one pass.

Its bound is HBM: 6 rows read and 3 written, 1.04 MB at the TC's 28,800
points in f32 (0.31 us at 3.35 TB/s), 11.9 MB at JW06's 331,776 (3.6 us);
about ten transcendentals a point.  On an H100 (700 W) it takes 3.4 us in a
graph at the TC's shape in f32, 5.6 in f64, and 11.4 / 22.8 us at JW06's,
where the plain chain took 281 / 322 and 407 / 544 us: the kernel is bound
by its transcendentals' latency (one point a thread), far from the bytes.

Everything that varies by configuration is a scalar of ``Params``, which
``microphysics.condensation_params`` reads once from the context for both
paths.  ``condensation_adjustment``, the step's call, takes the plain chain
(``microphysics.condensation_adjustment_plain``) for a CPU tensor and the
kernel for a CUDA tensor: in place where neither autograd nor a functorch
transform sees the call, otherwise through ``CondensationFn``, out of place,
whose backward and jvp differentiate the plain chain and whose vmap rule
folds the members into one launch.  Each launch adds 1 to the ``trace``
counter ``condensation.launches``, each run of the plain chain on a CUDA
tensor (the rules' recomputes) to ``condensation.plain_launches``.
``library`` declares the kernel's entry points, beside the call whose
argument order they describe.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from .. import trace
from ..device import traced_reason
from ._build import load

THREADS = 128  # threads a block, one point a thread


@dataclass(frozen=True)
class Params:
    """The adjustment's configuration as scalars: the mode, its relaxation
    factor ``tau_r``, the diagnostic cap (rate cap x ts) and finite-timescale
    factor 1 - exp(-ts/tau) (None without a timescale), whether the raw
    dmudq is the source Jacobian (``reference_quirks``), and the rows of
    ``var_np1`` (``mu_r`` None where the state has no rain)."""

    diagnostic: bool
    tau_r: float
    cap: float
    tau_factor: float | None
    quirks: bool
    s: int
    xi: int
    mu: int
    cloud: int
    mu_r: int | None
    qss: int


def takes_layout(var) -> bool:
    """Whether the kernel can adjust ``var`` [nvars, A, *rest] in place as
    it lies: the rest of each (variable, a) block contiguous, and the
    variable and A axes at any strides that keep the blocks apart (the
    step's state lies as [a][variable][rest])."""
    if var.ndim < 2 or var.numel() == 0 or not var[0, 0].is_contiguous():
        return False
    span = math.prod(var.shape[2:])
    for stride, n in sorted((st, n) for n, st in zip(var.shape[:2], var.stride()[:2])
                            if n > 1):
        if stride < span:
            return False
        span = stride * n
    return True


def _check(var, refs, prm: Params) -> tuple[int, int, int]:
    """(points, inner, nz) of ``var`` [nvars, *spatial], z last: points the
    spatial size, inner the points of one (variable, first spatial index)
    block; the reference columns must be [nz, k] in its dtype on its device."""
    if var.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the condensation kernel takes float32 or float64, got {var.dtype}")
    if var.ndim < 2:
        raise ValueError(f"var_np1 must be [nvars, *spatial], got {tuple(var.shape)}")
    if not takes_layout(var):
        raise ValueError(
            f"the condensation kernel takes var_np1 [nvars, A, *rest] with each (variable, "
            f"a) block contiguous and apart from the others; got shape {tuple(var.shape)} "
            f"strides {var.stride()}")
    rows = [prm.s, prm.xi, prm.mu, prm.cloud, prm.qss] + (
        [] if prm.mu_r is None else [prm.mu_r])
    if not all(0 <= r < var.shape[0] for r in rows):
        raise ValueError(f"rows {rows} out of var_np1's {var.shape[0]} variables")
    nz = var.shape[-1]
    npts = var[0].numel()
    inner = math.prod(var.shape[2:])
    if var.numel() >= 2**31 or max(var.stride()[:2]) >= 2**31:
        raise ValueError(f"var_np1 has {var.numel()} elements at strides {var.stride()}; "
                         f"the kernel takes < 2**31 of each")
    for name, t in zip(("sbar", "xibar", "mubar"), refs):
        if t.dtype != var.dtype or t.device != var.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; var_np1 is {var.dtype} "
                             f"on {var.device}")
        if t.ndim != 2 or t.shape[0] != nz or t.stride(1) != 1:
            raise ValueError(f"{name} must be [nz = {nz}, k] with unit stride along k, "
                             f"got {tuple(t.shape)} strides {t.stride()}")
    if not var.is_cuda:
        raise ValueError(f"the condensation kernel runs on a CUDA tensor, got {var.device}")
    return npts, inner, nz


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel library with this module's entry points declared; each
    returns 0 or a cudaError_t."""
    lib = load().lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("scythe_condensation_f32", "scythe_condensation_f64"):
        fn = getattr(lib, name)
        # var, sbar, xibar, mubar; their three row strides; npts, inner and
        # var's two outer strides, nz; the rows s xi mu cloud mu_r qss;
        # diagnostic, quirks, has_tau; tau_r, cap, factor; blocks, threads;
        # stream
        fn.argtypes = ([ptr] * 4 + [i32] * 3 + [i32] * 5 + [i32] * 6 + [i32] * 3
                       + [ctypes.c_double] * 3 + [i32] * 2 + [ptr])
        fn.restype = i32
    return lib


def condensation_adjust(var, sbar, xibar, mubar, prm: Params):
    """The adjustment of ``var`` [nvars, *spatial] (z last, in a layout
    ``takes_layout`` accepts, on a CUDA device) by the kernel, in place in
    its s, mu and cloud rows; the reference columns are read at [:, 0].
    Returns ``var``; raises on what the kernel does not take."""
    refs = (sbar, xibar, mubar)
    npts, inner, nz = _check(var, refs, prm)
    lib = library()
    fn = lib.scythe_condensation_f32 if var.dtype == torch.float32 else (
        lib.scythe_condensation_f64)
    blocks = -(-npts // THREADS)
    with torch.cuda.device(var.device):
        stream = torch.cuda.current_stream(var.device).cuda_stream
        err = fn(
            var.data_ptr(), sbar.data_ptr(), xibar.data_ptr(), mubar.data_ptr(),
            sbar.stride(0), xibar.stride(0), mubar.stride(0), npts, inner,
            var.stride(0), var.stride(1), nz,
            prm.s, prm.xi, prm.mu, prm.cloud, -1 if prm.mu_r is None else prm.mu_r, prm.qss,
            int(prm.diagnostic), int(prm.quirks), int(prm.tau_factor is not None),
            prm.tau_r, prm.cap, 1.0 if prm.tau_factor is None else prm.tau_factor,
            blocks, THREADS, stream,
        )
    if err != 0:
        msg = lib.scythe_cuda_error_string(err).decode()
        raise RuntimeError(f"condensation kernel launch failed: {msg} ({err})")
    trace.count("condensation.launches", 1)
    return var


def _plain(var, sbar, xibar, mubar, prm):
    """The plain chain, which the rules below differentiate; a run on a CUDA
    tensor is counted in ``condensation.plain_launches``."""
    from ..physics.microphysics import condensation_adjustment_plain

    if var.is_cuda:
        trace.count("condensation.plain_launches", 1)
    return condensation_adjustment_plain(var, sbar, xibar, mubar, prm)


def condensation_adjustment(var, sbar, xibar, mubar, prm: Params):
    """The adjustment of ``var`` [nvars, *spatial] (z last) with the
    reference columns sbar, xibar, mubar [nz, k] (read at [:, 0]): on the
    CPU the plain chain, into a new tensor; on a CUDA device the kernel, in
    place in ``var``'s own rows, which it returns, where neither autograd nor
    a functorch transform sees the call, otherwise through
    ``CondensationFn``, out of place."""
    refs = (sbar, xibar, mubar)
    if not var.is_cuda:
        return _plain(var, *refs, prm)
    if traced_reason((var, *refs)) is None:
        return condensation_adjust(var, *refs, prm)
    return CondensationFn.apply(var, *refs, prm)


class CondensationFn(torch.autograd.Function):
    """The adjustment as a differentiable operation, out of place: on a CUDA
    device the kernel on a contiguous copy of ``var``, on the CPU the plain
    chain; every rule below runs on both devices the same way, so the CPU
    tests check the formulas the card uses.

    * backward: the vjp of the plain chain (``torch.func.vjp``) at the saved
      input, for ``var`` and the reference columns alike;
    * jvp: the plain chain's ``torch.func.jvp`` at the saved input;
    * vmap: the map is pointwise, so the members become the A axis (the
      spatial axes after it, z last), one launch for all members.

    On the card the rules' recomputes are the only runs of the plain chain
    (``condensation.plain_launches``): the forward is always the kernel."""

    generate_vmap_rule = False

    @staticmethod
    def forward(var, sbar, xibar, mubar, prm):
        if var.device.type == "cpu":
            return _plain(var, sbar, xibar, mubar, prm)
        out = var.clone(memory_format=torch.contiguous_format)
        return condensation_adjust(out, sbar, xibar, mubar, prm)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.prm = inputs[4]
        ctx.save_for_backward(*inputs[:4])
        ctx.save_for_forward(*inputs[:4])

    @staticmethod
    def backward(ctx, g):
        prm = ctx.prm
        _, vjp = torch.func.vjp(lambda *x: _plain(*x, prm), *ctx.saved_tensors)
        return (*vjp(g), None)

    @staticmethod
    def jvp(ctx, *tangents):
        primals = ctx.saved_tensors
        tangents = tuple(torch.zeros_like(p) if t is None else t
                         for p, t in zip(primals, tangents[:4]))
        prm = ctx.prm
        return torch.func.jvp(lambda *x: _plain(*x, prm), primals, tangents)[1]

    @staticmethod
    def vmap(info, in_dims, var, sbar, xibar, mubar, prm):
        if any(d is not None for d in in_dims[1:4]):
            raise NotImplementedError(
                "the condensation adjustment reads one reference state for every "
                "member; its columns cannot carry a batch dimension"
            )
        # [nvars, members, *spatial]: z stays last, so each point keeps its level
        return CondensationFn.apply(var.movedim(in_dims[0], 1), sbar, xibar, mubar, prm), 1
