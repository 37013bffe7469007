"""Fused RLZ spectral analysis: a hand-written CUDA kernel for Hopper and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``scythe_tpu/ops/pallas_transforms.py``
(``build_rlz_analysis``).  Physical ``[V, rDim, nl, nz]`` to spectral
``[V, b_rDim, nl, nz]`` in one pass, per variable v:

    a[r,k,z]     = ring_mask[r,k] * sum_l l_analysis[k,l] x[v,r,l,z]
    c[b,k,z]     = sum_r analysis_r[v,b,r] a[r,k,z]
    out[v,b,k,K] = sum_z analysis_z[v,K,z] c[b,k,z]

with the grid's own operators in its dtype (f32 or f64): ``mode="plain"``.
``mode="comp"`` is the TPU kernel's own arithmetic, on a compensated grid:
the operators come as the grid's [O_hi, O_lo, O_hi] bf16 stacks, every
contraction is hi·hi + lo·hi + hi·lo with f32 accumulation, and the
activation is split into bf16 hi/lo before each contraction (x, the masked
lambda coefficients, the radial sums), as the TPU kernel re-splits; f32
only.  The kernel (``csrc/rlz_analysis.cu``)
launches one thread-block cluster per (variable, k-tile, b-tile) whose
blocks split r and reduce their partial sums over distributed shared
memory; ``plan`` sizes its tiles, and the kernel's header says what bounds
it.  The wrapper ``rlz_analysis`` checks its inputs, then goes through
``RLZAnalysisFn``, a ``torch.autograd.Function``: the plain version for
tensors on the CPU, the kernel for tensors on a CUDA device, with no
fallback between the two; its jvp is the kernel on the tangents, its vmap
folds members into V (one launch), its backward the transposed chain as
einsums (the JAX package has no backward kernel either; in comp mode
the transposed chain of the operators O_hi + O_lo in f32, where the JAX
package's gradient through its compensated ``_mm`` rounds the cotangents to
bf16).  ``launches`` counts plain-mode kernel launches, ``comp_launches``
comp-mode ones.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from .bf16x3 import comp_einsum

# the kernel's limits (rlz_analysis.cu): nz as the column solve's, nl as the
# dense DFT's (grids/base.py); a larger shape raises on CUDA
MAX_NZ = 128
MAX_NL = 2048

THREADS = (256, 512)  # a block (its last warp produces): the kernel's two
BARRIER_BYTES = 128  # the kernel's mbarriers, ahead of the tiles
SMEM_MAX = 232_448  # dynamic shared memory a block may use on Hopper
SMEM_TWO_A_SM = 115_712  # half the SM's 228 KiB, less 1 KiB reserved a block
ACC_MAX = 136 * 1024  # accumulator bytes a block
NUM_SMS = 132  # H100 SXM
# the share of the SMs that clusters of c blocks fill at one block an SM
# (cudaOccupancyMaxActiveClusters on an H100 SXM: 66, 39, 30 and 30
# clusters of 2, 3, 4 and 8); 5-7 taken as 4's
CLUSTER_FILL = {1: 1.0, 2: 1.0, 3: 117 / 132, 4: 120 / 132, 5: 0.9, 6: 0.9, 7: 0.9,
                8: 120 / 132}
SMALL_ACC = 48 * 1024  # accumulator bytes under which two blocks share an SM
MAX_CLUSTER = 8  # the portable cluster size
MAX_KT = 16  # azimuthal wavenumbers a tile (the kernel's kMaxKt)
MAX_RC = 64  # radial rows a chunk (the kernel's kMaxRc)
MAX_ST = 4  # slots in the staging ring (the kernel takes 2 to 4)
MIN_SLICE_ROWS = 8  # r rows a block at least, before r is split further

# what the kernel returns when it refuses a plan (rlz_analysis.cu)
PLAN_ERRORS = {
    -1: "shape out of range",
    -2: "tile out of range",
    -3: "shared memory differs from the layout or exceeds 232448 bytes",
    -4: "no cluster of this plan fits on an SM",
    -5: "cuTensorMapEncodeTiled is missing or refused the tensor map of x",
}

MODES = ("plain", "comp")

launches = 0  # plain-mode launches
comp_launches = 0  # comp-mode launches


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _up4(n: int) -> int:
    return _cdiv(n, 4) * 4


@dataclass(frozen=True)
class Plan:
    """One launch's tiles.  A block owns (r-slice, k-tile of ``kt``
    wavenumbers, b-tile of ``bt`` radial coefficients, variable); the ``c``
    r-slices of one (k-tile, b-tile, variable) form a cluster.  A block
    streams its rows in chunks of ``rc`` rows and ``lc`` azimuths, and
    stages the vertical operator in chunks of ``zc`` rows.  ``grid`` is
    (c, k-tiles x b-tiles, V); ``smem`` the bytes of dynamic shared memory a
    block, as the kernel lays them out."""

    kt: int
    bt: int
    c: int
    rc: int
    lc: int
    zc: int
    st: int
    threads: int
    smem: int
    grid: tuple[int, int, int]

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def smem_layout(Z: int, es: int, kt: int, bt: int, c: int, rc: int, lc: int,
                zc: int, st: int, nops: int = 1) -> tuple[int, int, int]:
    """Bytes of (accumulator, main-loop staging, epilogue) as the kernel lays
    them out; a block takes BARRIER_BYTES + accumulator + max(staging,
    epilogue).  Rows of z are padded to a multiple of 4, as are the k and b
    extents.  ``nops``: parts an operator tile is staged in, 1 (plain) or 2
    (comp: hi, then lo)."""
    zp, ktp, btp = _up4(Z), _up4(kt), _up4(bt)
    acc = btp * ktp * zp
    # x pieces (st slots, each 128-byte aligned for the copy engine),
    # l_analysis pieces (st slots), analysis_r and ring_mask chunks (two
    # slots), and the chunk's lambda coefficients
    x = _cdiv(rc * lc * zp, 128 // es) * (128 // es)
    stage = (st * (x + nops * lc * ktp) + 2 * (nops * rc * btp + rc * ktp)
             + rc * ktp * zp)
    # this block's reduced rows, and a chunk of the vertical operator
    epilogue = _up4(_cdiv(bt * kt, c)) * zp + nops * _up4(zc) * zp
    return acc * es, stage * es, epilogue * es


def _smem(Z, es, nops, *tiles) -> int:
    acc, stage, epi = smem_layout(Z, es, *tiles, nops=nops)
    return BARRIER_BYTES + acc + max(stage, epi)


def lanes_a_row(kt: int, Z: int) -> int:
    """Consumer threads one radial row of a chunk takes in the lambda stage,
    a 4 k x 4 z tile each (the kernel's per_r)."""
    return _up4(kt) // 4 * (_up4(Z) // 4)


def _est_cycles(R, L, Z, B, V, kt, bt, c, bps, fmas=1) -> float:
    """The plan's cost model: the waves of the grid times the cycles of one
    block, with rates measured on the card (H100 SXM, clock64 phases):
    ~34 FMA a clock on an SM in the lambda and radial stages, ~25 in the
    vertical stage, ~12k clocks of set-up, barriers and reduction; ``bps``
    blocks an SM, ``fmas`` FMAs a product (3 in comp mode)."""
    zp = _up4(Z)
    ctas = c * _cdiv(L, kt) * _cdiv(B, bt) * V
    wave = int(NUM_SMS * bps * CLUSTER_FILL[c])
    rows = _cdiv(R, c)
    share = _cdiv(bt * kt, c)
    # two blocks on an SM share its FMA rate: they overlap only latency
    block = fmas * bps * (rows * (_up4(kt) * L + _up4(bt) * _up4(kt)) * zp / 34.0
                          + share * zp * zp / 25.0) + 12_000.0
    return _cdiv(ctas, wave) * block


def plan(phys_shape, b_rdim: int, dtype, mode: str = "plain") -> Plan:
    """The kernel's tiles at this shape; pure Python, the plan's only home
    (cached: the wrapper asks for it on every call).

    Three costs are traded:
      * accumulator bytes, ``bt * kt * nz * elem`` a block, held to 136 KiB
        (with the staging, the block must fit 227 KiB; at most ~113 KiB
        lets two blocks share an SM);
      * the lambda DFT, recomputed once per b-tile (``b_rDim / bt`` times);
      * x, re-read from L2 once per k-tile (``nl / kt`` times).
    So ``kt`` is 8 (all of nl when smaller), halved to 4 when the whole of
    b_rDim would not fit the accumulator, and b is tiled only where it must
    fit.  f64 halves what fits: where f32 keeps kt 8 it takes kt 4, or
    splits b.  Then the cluster size ``c`` (r split) and any further b
    split are chosen by ``_est_cycles``, which counts whole waves: a grid
    just past a wave costs a second one.  A block of 512 threads (one an
    SM) takes a large accumulator, one of 256 (two an SM) a small one.  The
    r-chunk is the largest (one lambda tile a consumer thread at most) for
    which two slots of an l-chunk of at least 12 azimuths fit.  In comp
    mode (f32 only) every operator tile is staged twice (hi and lo) and a
    product costs three FMAs, so the same rules run on that layout and cost.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "comp" and dtype != torch.float32:
        raise ValueError(f"the comp mode runs in float32, got {dtype}")
    return _plan(tuple(int(n) for n in phys_shape), int(b_rdim), dtype, mode)


@functools.lru_cache(maxsize=64)
def _plan(phys_shape, B, dtype, mode) -> Plan:
    V, R, L, Z = phys_shape
    es = torch.empty((), dtype=dtype).element_size()
    zp = _up4(Z)
    nops = fmas = 1
    if mode == "comp":
        nops, fmas = 2, 3

    def smem(*tiles):
        return _smem(Z, es, nops, *tiles)

    def acc_bytes(bt, kt):
        return _up4(bt) * _up4(kt) * zp * es

    kt = min(8, L)
    if kt > 4 and acc_bytes(B, kt) > ACC_MAX:
        kt = 4
    bt_max = B
    while bt_max > 1 and acc_bytes(bt_max, kt) > ACC_MAX:
        bt_max = _cdiv(B, _cdiv(B, bt_max) + 1)

    def bps(bt):  # blocks an SM: two where the accumulator is small
        return 2 if acc_bytes(bt, kt) <= SMALL_ACC else 1

    def fits(bt, c):  # the epilogue's share of rows beside the accumulator
        return smem(kt, bt, c, 1, 1, 1, 2) <= SMEM_MAX

    options = [
        (_est_cycles(R, L, Z, B, V, kt, bt, c, bps(bt), fmas), c, -bt)
        for c in range(1, MAX_CLUSTER + 1) if c == 1 or _cdiv(R, c) >= MIN_SLICE_ROWS
        for bt in sorted({_cdiv(B, n) for n in range(1, _cdiv(B, 16) + 1)} | {bt_max})
        if bt <= bt_max and fits(bt, c)
    ]
    if not options:  # only the narrowest b-tiles fit beside the epilogue
        bt = next(b for b in range(bt_max, 0, -1) if fits(b, 1))
        options = [(0.0, 1, -bt)]
    _, c, bt = min(options)
    bt = -bt
    n_bt = _cdiv(B, bt)

    rows = _cdiv(R, c)
    per_r = lanes_a_row(kt, Z)

    def chunks(threads, cap, lc_min):
        """(rc, lc, st): the largest r-chunk, one lambda tile a consumer
        thread at most, for which two slots (three where they cost nothing)
        of an l-chunk of at least lc_min fit under cap; None if none does."""
        for rc0 in range(min(MAX_RC, (threads - 32) // per_r, rows), 0, -1):
            rc = _cdiv(rows, _cdiv(rows, rc0))  # balanced chunks
            for lc in range(min(L, 64), lc_min - 1, -1):
                if smem(kt, bt, c, rc, lc, 1, 2) <= cap:
                    lc = _cdiv(L, _cdiv(L, lc))  # balanced chunks
                    st = 3 if lc == L and smem(kt, bt, c, rc, lc, 1, 3) <= cap else 2
                    return rc, lc, st
        return None

    threads, cap = (256, SMEM_TWO_A_SM) if bps(bt) == 2 else (512, SMEM_MAX)
    found = chunks(threads, cap, min(L, 12))
    if found is None:
        threads, cap = 512, SMEM_MAX
        found = chunks(threads, cap, min(L, 12)) or chunks(threads, cap, 1)
    rc, lc, st = found
    zc = Z  # else a multiple of 4
    while zc > 4 and smem(kt, bt, c, rc, lc, zc, st) > cap:
        zc = (zc - 1) // 4 * 4
    return Plan(kt=kt, bt=bt, c=c, rc=rc, lc=lc, zc=zc, st=st, threads=threads,
                smem=smem(kt, bt, c, rc, lc, zc, st), grid=(c, _cdiv(L, kt) * n_bt, V))


def rlz_analysis_plain(phys, l_analysis, ring_mask, analysis_r, analysis_z):
    """The chain in plain PyTorch: the einsums of ``Grid._analysis_with``
    (lambda DFT, ring mask, radial contraction, vertical analysis)."""
    hat = torch.einsum("kl,vrlz->vrkz", l_analysis, phys)
    hat = hat * ring_mask[None, :, :, None]
    rc = torch.einsum("vbr,vrkz->vbkz", analysis_r, hat)
    return torch.einsum("vKz,vbkz->vbkK", analysis_z, rc)


def rlz_analysis_comp_plain(phys, l_analysis, ring_mask, analysis_r, analysis_z):
    """The comp mode in plain PyTorch: the chain of a compensated grid's
    ``_analysis_with``, each contraction bf16x3 over the operator stacks
    ([3, ...]: O_hi, O_lo, O_hi) with the activation split before it."""
    hat = comp_einsum("kl,vrlz->vrkz", l_analysis, phys)
    hat = hat * ring_mask[None, :, :, None]
    rc = comp_einsum("vbr,vrkz->vbkz", analysis_r, hat)
    return comp_einsum("vKz,vbkz->vbkK", analysis_z, rc)


def _check(phys, ops, mode="plain") -> tuple[int, int, int, int, int]:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if phys.ndim != 4:
        raise ValueError(f"phys must be [V, rDim, nl, nz]; got {tuple(phys.shape)}")
    V, R, L, Z = phys.shape
    if phys.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {phys.dtype}")
    names = ("l_analysis", "ring_mask", "analysis_r", "analysis_z")
    for name, t in zip(names, ops):
        if t.dtype != phys.dtype or t.device != phys.device:
            raise ValueError(
                f"{name} is {t.dtype} on {t.device}; phys is {phys.dtype} on "
                f"{phys.device}"
            )
    # comp: the operators are [3, ...] stacks (O_hi, O_lo, O_hi)
    stack = (3,) if mode == "comp" else ()
    an = ops[2]
    B = an.shape[len(stack) + 1] if an.ndim == 3 + len(stack) else 0
    want = {
        "l_analysis": stack + (L, L),
        "ring_mask": (R, L),
        "analysis_r": stack + (V, B, R),
        "analysis_z": stack + (V, Z, Z),
    }
    for name, t in zip(names, ops):
        if tuple(t.shape) != want[name]:
            raise ValueError(
                f"{name} must be {list(want[name])} for phys "
                f"{list(phys.shape)} in {mode} mode, got {list(t.shape)}"
            )
    return V, R, L, Z, B


def _launch(phys, ops, shape, mode):
    global launches, comp_launches
    from ._build import load

    V, R, L, Z, B = shape
    if not 1 <= Z <= MAX_NZ or not 1 <= L <= MAX_NL:
        raise ValueError(
            f"the rlz_analysis kernel takes nz <= {MAX_NZ} and nl <= {MAX_NL}; "
            f"got nz = {Z}, nl = {L}"
        )
    if mode == "comp":
        if phys.dtype != torch.float32:
            raise ValueError(f"the comp mode runs in float32, got {phys.dtype}")
        # the kernel reads hi then lo of each operator: the stack's first two
        la, mask, an, az = ops
        ops = (la[:2], mask, an[:2], az[:2])
    for t in (phys,) + tuple(ops):
        if not t.is_contiguous():
            raise ValueError("the rlz_analysis kernel needs contiguous tensors")
    p = plan(phys.shape, B, phys.dtype, mode)
    lib = load().lib
    if mode == "comp":
        fn = lib.scythe_rlz_analysis_comp
    elif phys.dtype == torch.float32:
        fn = lib.scythe_rlz_analysis_f32
    else:
        fn = lib.scythe_rlz_analysis_f64
    out = torch.empty((V, B, L, Z), dtype=phys.dtype, device=phys.device)
    with torch.cuda.device(phys.device):
        stream = torch.cuda.current_stream(phys.device).cuda_stream
        err = fn(
            phys.data_ptr(), *(o.data_ptr() for o in ops), out.data_ptr(),
            V, R, L, Z, B, p.kt, p.bt, p.c, p.rc, p.lc, p.zc, p.st, p.threads,
            p.smem, stream,
        )
    if err != 0:
        msg = PLAN_ERRORS.get(err) or lib.scythe_cuda_error_string(err).decode()
        raise RuntimeError(f"rlz_analysis kernel launch failed: {msg} ({err}); {p}")
    if mode == "comp":
        comp_launches += 1
    else:
        launches += 1
    return out


def rlz_analysis_transposed(g, l_analysis, ring_mask, analysis_r, analysis_z):
    """The adjoint of the analysis: spectral cotangents ``[V, b_rDim, nl,
    nz]`` to physical ``[V, rDim, nl, nz]``, the chain transposed
    (analysis_z^T, analysis_r^T, the ring mask, l_analysis^T) as einsums on
    either device; the JAX package differentiates its einsum chain the same
    way (no Pallas backward exists)."""
    gc = torch.einsum("vKz,vbkK->vbkz", analysis_z, g)
    ga = torch.einsum("vbr,vbkz->vrkz", analysis_r, gc)
    ga = ga * ring_mask[None, :, :, None]
    return torch.einsum("kl,vrkz->vrlz", l_analysis, ga)


def _unsplit(op3):
    """O_hi + O_lo of a [3, ...] operator stack: the operator the comp mode
    approximates, to bf16x2 precision."""
    return op3[0] + op3[1]


class RLZAnalysisFn(torch.autograd.Function):
    """The analysis as a differentiable operation: on the CPU its plain
    version, on a CUDA device the kernel, in the mode given; every rule
    below runs on both devices the same way, so the CPU tests check the
    formulas the card uses.

    * jvp: the map is linear in phys (in comp mode, up to its splits'
      rounding), so the kernel on the tangents, in the same mode;
    * vmap: the batch folded into V, with analysis_r and analysis_z
      repeated along it, one launch for all members;
    * backward: the transposed chain (rlz_analysis_transposed), as einsums;
      in comp mode of the operators O_hi + O_lo, in f32 (the JAX package's
      jax.grad through its compensated _mm rounds the cotangents to bf16 at
      its casts: tests/test_torch_compensated.py holds the two apart at
      the tolerance that gives).

    The operators get no gradient: they are the grid's, fixed at its build."""

    generate_vmap_rule = False

    @staticmethod
    def forward(phys, l_analysis, ring_mask, analysis_r, analysis_z, mode):
        ops = (l_analysis, ring_mask, analysis_r, analysis_z)
        if phys.device.type == "cpu":
            plain = rlz_analysis_comp_plain if mode == "comp" else rlz_analysis_plain
            return plain(phys, *ops)
        if phys.device.type != "cuda":
            raise ValueError(f"rlz_analysis runs on cpu or cuda tensors, got {phys.device}")
        phys = phys.contiguous()
        return _launch(phys, ops, _check(phys, ops, mode), mode)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mode = inputs[5]
        ctx.save_for_backward(*inputs[1:5])
        ctx.save_for_forward(*inputs[1:5])

    @staticmethod
    def backward(ctx, g):
        la, mask, an, az = ctx.saved_tensors
        if ctx.mode == "comp":
            la, an, az = _unsplit(la), _unsplit(an), _unsplit(az)
        return (rlz_analysis_transposed(g, la, mask, an, az),) + (None,) * 5

    @staticmethod
    def jvp(ctx, phys_t, *_):
        return RLZAnalysisFn.apply(phys_t, *ctx.saved_tensors, ctx.mode)

    @staticmethod
    def vmap(info, in_dims, phys, l_analysis, ring_mask, analysis_r, analysis_z, mode):
        if any(d is not None for d in in_dims[1:]):
            raise NotImplementedError(
                "the RLZ analysis applies the grid's operators to every member; "
                "they cannot carry a batch dimension"
            )
        if in_dims[0] is None:
            return RLZAnalysisFn.apply(phys, l_analysis, ring_mask, analysis_r,
                                       analysis_z, mode), None
        x = phys.movedim(in_dims[0], 0)
        n, V = x.shape[:2]
        # the variable axis of analysis_r / analysis_z (after a comp stack's)
        rep = (1, n, 1, 1) if mode == "comp" else (n, 1, 1)
        out = RLZAnalysisFn.apply(x.reshape(n * V, *x.shape[2:]), l_analysis, ring_mask,
                                  analysis_r.repeat(*rep), analysis_z.repeat(*rep), mode)
        return out.reshape(n, V, *out.shape[1:]), 0


def rlz_analysis(phys, l_analysis, ring_mask, analysis_r, analysis_z, mode="plain"):
    """Physical ``[V, rDim, nl, nz]`` -> spectral ``[V, b_rDim, nl, nz]``
    with the RLZ grid's operators (``Grid.l_analysis``, ``ring_mask``,
    ``analysis_r``, ``analysis_z``), through RLZAnalysisFn.  ``mode``:
    "plain" (operators in phys' dtype) or "comp" (a compensated grid's
    [3, ...] operator stacks, float32)."""
    ops = (l_analysis, ring_mask, analysis_r, analysis_z)
    _check(phys, ops, mode)
    return RLZAnalysisFn.apply(phys, *ops, mode)
