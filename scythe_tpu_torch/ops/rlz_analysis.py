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
it.  Its comp body runs on the bf16 tensor cores (``mma.sync m16n8k16``)
and reads the operators packed once a grid in fragment order
(``comp_operators``, kept on the analysis_r tensor: no launch a call).
The wrapper ``rlz_analysis`` checks its inputs, then goes through
``RLZAnalysisFn``, a ``torch.autograd.Function``: the plain version for
tensors on the CPU, the kernel for tensors on a CUDA device, with no
fallback between the two; its jvp is the kernel on the tangents, its vmap
folds members into V (one launch), its backward the transposed chain as
einsums (the JAX package has no backward kernel either; in comp mode
the transposed chain of the operators O_hi + O_lo in f32, where the JAX
package's gradient through its compensated ``_mm`` rounds the cotangents to
bf16).  Each launch adds 1 to a ``trace`` counter, ``rlz_analysis.launches``
in plain mode and ``rlz_analysis.comp_launches`` in comp mode, and each
packing of the comp operators to ``rlz_analysis.packs``; a packing inside a
CUDA graph capture raises (a first-use cost the warm-up step should have
paid).  ``library`` declares the library's entry points, beside the calls
whose argument order they describe.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from dataclasses import dataclass
from typing import NamedTuple

import torch

from .. import trace
from ._build import load
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
    block, as the kernel lays them out.  In comp mode x lands in pieces of
    ``rp`` rows (rc / rp of them a chunk; the plain mode's pieces are
    whole chunks, rp = rc) and analysis_z is staged whole (zc = nz)."""

    kt: int
    bt: int
    c: int
    rc: int
    rp: int
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
                zc: int, st: int) -> tuple[int, int, int]:
    """Bytes of (accumulator, main-loop staging, epilogue) as the plain
    kernel lays them out; a block takes BARRIER_BYTES + accumulator +
    max(staging, epilogue).  Rows of z are padded to a multiple of 4, as are
    the k and b extents."""
    zp, ktp, btp = _up4(Z), _up4(kt), _up4(bt)
    acc = btp * ktp * zp
    # x pieces (st slots, each 128-byte aligned for the copy engine),
    # l_analysis pieces (st slots), analysis_r and ring_mask chunks (two
    # slots), and the chunk's lambda coefficients
    x = _cdiv(rc * lc * zp, 128 // es) * (128 // es)
    stage = st * (x + lc * ktp) + 2 * (rc * btp + rc * ktp) + rc * ktp * zp
    # this block's reduced rows, and a chunk of the vertical operator
    epilogue = _up4(_cdiv(bt * kt, c)) * zp + _up4(zc) * zp
    return acc * es, stage * es, epilogue * es


def _smem(Z, es, *tiles) -> int:
    acc, stage, epi = smem_layout(Z, es, *tiles)
    return BARRIER_BYTES + acc + max(stage, epi)


def _up(n: int, m: int) -> int:
    return _cdiv(n, m) * m


def comp_widths(Z: int, kt: int) -> tuple[int, int, int, int]:
    """(ZA, ZB, Z16, KT8) of the comp kernel: z padded to 8 for the
    products; a row of x in shared memory, ZA words padded to 8 or 24 mod
    32 (the lambda stage's four lanes of a row then read distinct banks);
    z padded to 16, the vertical stage's K; the k-tile padded to 8."""
    za = _up(Z, 8)
    return za, za + 8 if za % 16 == 0 else za, _up(Z, 16), _up(kt, 8)


def comp_smem_layout(Z: int, R: int, kt: int, bt: int, c: int, rc: int, rp: int, lc: int,
                     st: int) -> tuple[int, int]:
    """Bytes of the comp kernel's two regions (its CompLayout); a block
    takes BARRIER_BYTES + both, every part on 128 bytes:

    * A: the slice's lambda coefficients [rc][AS] bf16, hi and lo (AS:
      [KT8][ZA] padded to an odd number of 16-byte units), analysis_r's
      fragments (1 KiB a 16 x 16 tile: 32 lanes x hi, lo) and the mask
      [rc][KT8]; after the radial stage, the reduced rows [up16(share)][Z16
      + 8] bf16, hi and lo, and analysis_z's fragments;
    * B: st pieces of x [rp][lc][ZB] f32 and of l_analysis' fragments (512
      bytes a 16 x 8 tile), and the f32 partial sums [bt][BS] (a row
      [KT8][ZA] padded to 8 mod 32 words): over the pieces where the
      r-slice is one chunk of rc rows (written once the lambda stage is
      done), after them where it takes several."""
    za, zb, z16, kt8 = comp_widths(Z, kt)
    bs = kt8 * za + (40 - kt8 * za % 32) % 32
    as_ = kt8 * za + (8 if (kt8 * za // 8) % 2 == 0 else 0)
    a = _up(2 * rc * as_ * 2, 128)
    an = _cdiv(bt, 16) * (rc // 16) * 1024
    ms = _up(rc * kt8 * 4, 128)
    red = _up(2 * _up(_cdiv(bt * kt, c), 16) * (z16 + 8) * 2, 128)
    az = z16 // 16 * (za // 8) * 512
    x = _up(rp * lc * zb * 4, 128)
    la = _cdiv(lc, 16) * (kt8 // 8) * 512
    acc = _up(bt * bs * 4, 128)
    ring = st * (x + la)
    one_chunk = rc >= comp_slice_rows(R, c)
    return max(a + an + ms, red + az), max(ring, acc) if one_chunk else ring + acc


def _comp_smem(Z, R, *tiles) -> int:
    return BARRIER_BYTES + sum(comp_smem_layout(Z, R, *tiles))


def lanes_a_row(kt: int, Z: int) -> int:
    """Consumer threads one radial row of a chunk takes in the lambda stage,
    a 4 k x 4 z tile each (the kernel's per_r)."""
    return _up4(kt) // 4 * (_up4(Z) // 4)


def _est_cycles(R, L, Z, B, V, kt, bt, c, bps) -> float:
    """The plan's cost model: the waves of the grid times the cycles of one
    block, with rates measured on the card (H100 SXM, clock64 phases):
    ~34 FMA a clock on an SM in the lambda and radial stages, ~25 in the
    vertical stage, ~12k clocks of set-up, barriers and reduction; ``bps``
    blocks an SM."""
    zp = _up4(Z)
    ctas = c * _cdiv(L, kt) * _cdiv(B, bt) * V
    wave = int(NUM_SMS * bps * CLUSTER_FILL[c])
    rows = _cdiv(R, c)
    share = _cdiv(bt * kt, c)
    # two blocks on an SM share its FMA rate: they overlap only latency
    block = bps * (rows * (_up4(kt) * L + _up4(bt) * _up4(kt)) * zp / 34.0
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
    which two slots of an l-chunk of at least 12 azimuths fit.  The comp
    mode (f32 only) has a kernel body of its own and its own plan
    (``_plan_comp``).
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "comp" and dtype != torch.float32:
        raise ValueError(f"the comp mode runs in float32, got {dtype}")
    shape = tuple(int(n) for n in phys_shape)
    if mode == "comp":
        return _plan_comp(shape, int(b_rdim))
    return _plan(shape, int(b_rdim), dtype)


@functools.lru_cache(maxsize=64)
def _plan(phys_shape, B, dtype) -> Plan:
    V, R, L, Z = phys_shape
    es = torch.empty((), dtype=dtype).element_size()
    zp = _up4(Z)

    def smem(*tiles):
        return _smem(Z, es, *tiles)

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
        (_est_cycles(R, L, Z, B, V, kt, bt, c, bps(bt)), c, -bt)
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
    return Plan(kt=kt, bt=bt, c=c, rc=rc, rp=rc, lc=lc, zc=zc, st=st, threads=threads,
                smem=smem(kt, bt, c, rc, lc, zc, st), grid=(c, _cdiv(L, kt) * n_bt, V))


COMP_THREADS = (256, 512)  # a comp block: 7 or 15 consumer warps and a producer
COMP_MAX_RC = 256  # radial rows a slice (the kernel's kCompMaxRc)
COMP_MAX_RP = 32  # radial rows a piece of x (kCompMaxRp)
COMP_MAX_LC = 64  # azimuths a piece of x (kCompMaxLc)
# the comp cost model's rates, cycles of one SM (clock64 marks of the
# kernel on an H100, tools/torch_comp_analysis_check.py --profile; PERF.md):
# x from L2 at ~32 bytes a clock an SM when every SM reads; a warp's lambda
# item (an m-tile by all wavenumbers) ~120 clocks a 16-deep k-step, a
# radial item ~150 a k-step; ~800 a piece of x (its barrier and latency),
# ~12k a block (set-up, cluster barriers, reduction, vertical stage)
COMP_X_BYTES_A_CLOCK = 32.0
COMP_LAMBDA_CLOCKS = 120.0
COMP_RADIAL_CLOCKS = 150.0
COMP_PIECE_CLOCKS = 800.0
COMP_BLOCK_CLOCKS = 12_000.0


def comp_items_fit(Z: int, kt: int, rp: int, threads: int) -> bool:
    """The lambda stage's m-tiles of a piece (rp rows x ZA / 16) fit the
    consumer warps' registers: 4 / NTK tiles a warp at most (NTK = KT8 / 8
    wavenumber tiles each)."""
    za, _, _, kt8 = comp_widths(Z, kt)
    return rp * za // 16 <= (threads - 32) // 32 * (4 // (kt8 // 8))


def comp_slice_rows(R: int, c: int) -> int:
    """Rows of one r-slice of the comp kernel (the cluster's c blocks): a
    multiple of 16, analysis_r's packed k-step."""
    return _up(_cdiv(R, c), 16)


def _comp_cycles(V, R, L, Z, B, kt, bt, c, rc, rp, lc, threads) -> float:
    za, _, _, kt8 = comp_widths(Z, kt)
    rows = comp_slice_rows(R, c)
    w = (threads - 32) // 32
    ctas = c * _cdiv(L, kt) * _cdiv(B, bt) * V
    bps = 2 if threads == COMP_THREADS[0] else 1
    wave = int(NUM_SMS * bps * CLUSTER_FILL[c])
    piece_x = rp * lc * Z * 4 / COMP_X_BYTES_A_CLOCK
    piece_mma = _cdiv(rp * za // 16, w) * _cdiv(lc, 16) * (kt8 // 8) * COMP_LAMBDA_CLOCKS
    n_rc = _cdiv(rows, rc)
    pieces = n_rc * (rc // rp) * _cdiv(L, lc)
    n_np = _cdiv(kt8 * za // 8, 2)
    radial = n_rc * _cdiv(_cdiv(_cdiv(bt, 16), 4) * n_np, w) * (rc // 16) * COMP_RADIAL_CLOCKS
    block = (pieces * (max(piece_x, piece_mma) + COMP_PIECE_CLOCKS) + radial
             + n_rc * COMP_PIECE_CLOCKS + COMP_BLOCK_CLOCKS)
    # two blocks on an SM share its bandwidth and issue slots; they overlap
    # each other's latencies
    return _cdiv(ctas, wave) * block * (1.3 if bps == 2 else 1.0)


@functools.lru_cache(maxsize=64)
def _plan_comp(phys_shape, B) -> Plan:
    """The comp kernel's tiles (``plan(..., mode="comp")``).

    A block takes its whole r-slice as one chunk where it fits (rc rows, a
    multiple of 16): the radial stage then runs once, over all of the
    slice's rows, and writes its partial sums once, over the ring of x
    that the lambda stage no longer needs.  Else the slice goes in chunks
    of rc rows (16 to 64), each chunk's radial products added into partial
    sums of their own region.  The chunk's lambda coefficients (bf16 hi
    and lo) and analysis_r fragments sit beside the ring.  Every (kt, bt,
    c, threads) is costed by
    ``_comp_cycles`` (x from L2 against the lambda products a piece, in
    whole rounds of the warps, the pieces' barriers, the radial stage,
    whole waves), with the piece of x that costs least (rp rows dividing
    rc, the lambda m-tiles within the warps' registers, lc azimuths: all of
    nl up to 64, else 16-64); then as many ring slots (2-4) as fit.  kt is
    8 or 16 (or all of
    nl below 16); bt all of b_rDim or a multiple of 16.  x is read once per
    (k-tile, b-tile)."""
    V, R, L, Z = phys_shape
    kts = sorted({k for k in (8, 16) if k <= L} | ({L} if L <= 16 else set()))
    bts = sorted({B} | {b for b in range(16, B, 16)}, reverse=True)
    lcs = [L] if L <= COMP_MAX_LC else []
    lcs += [lc for lc in (64, 48, 32, 16) if lc < min(L, COMP_MAX_LC + 1)]
    best = None
    for kt, bt, c, threads in itertools.product(kts, bts, range(1, MAX_CLUSTER + 1),
                                                COMP_THREADS):
        rows = comp_slice_rows(R, c)
        if c > 1 and (c - 1) * rows >= R:
            continue  # an empty r-slice
        cap = SMEM_TWO_A_SM if threads == COMP_THREADS[0] else SMEM_MAX
        for rc in [rows] * (rows <= COMP_MAX_RC) + list(range(min(64, rows - 16), 15, -16)):
            pieces = sorted(((rp * lc, rp, lc) for lc in lcs
                             for rp in range(min(rc, COMP_MAX_RP), 1, -2)
                             if rc % rp == 0 and comp_items_fit(Z, kt, rp, threads)),
                            reverse=True)
            # at equal cost the most rows a piece: more lambda items for the
            # warps at once (measured faster on the card)
            fit = [(_comp_cycles(V, R, L, Z, B, kt, bt, c, rc, rp, lc, threads), -rp, lc)
                   for _, rp, lc in pieces
                   if _comp_smem(Z, R, kt, bt, c, rc, rp, lc, 2) <= cap]
            if not fit:
                continue
            cost, rp, lc = min(fit)
            rp = -rp
            # one chunk first: measured on the card, chunked slices (their
            # radial stage run and added per chunk) lost to it at every
            # shape where both fit
            key = (rc != rows, cost, -kt, -bt, c, threads, -rc)
            if best is None or key < best[0]:
                best = (key, kt, bt, c, rc, rp, lc, threads)
    if best is None:
        raise ValueError(f"no comp plan fits shared memory at {phys_shape}, b_rDim {B}")
    _, kt, bt, c, rc, rp, lc, threads = best
    cap = SMEM_TWO_A_SM if threads == COMP_THREADS[0] else SMEM_MAX
    st = max(n for n in (2, 3, 4) if _comp_smem(Z, R, kt, bt, c, rc, rp, lc, n) <= cap or n == 2)
    return Plan(kt=kt, bt=bt, c=c, rc=rc, rp=rp, lc=lc, zc=Z, st=st, threads=threads,
                smem=_comp_smem(Z, R, kt, bt, c, rc, rp, lc, st),
                grid=(c, _cdiv(L, kt) * _cdiv(B, bt), V))


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


class CompOperators(NamedTuple):
    """A compensated grid's three operators packed once for the comp
    kernel (``comp_operators``), bf16 hi and lo in the order its
    tensor-core fragments read them, as int32 pairs of bf16 (the lower
    index in the low half):

    * ``la``: l_analysis as the lambda stage's B operand, [L16/16, L8/8, 32,
      4]: k-step ks of 16 azimuths, n-tile of 8 wavenumbers, lane g*4 + t,
      {hi b0, hi b1, lo b0, lo b1}; b0 holds azimuths 16 ks + t, + 4 of
      wavenumber 8 nt + g, b1 azimuths + 8, + 12 (the kernel reads x in
      that order, so its lanes hit distinct banks);
    * ``an``: analysis_r as the radial stage's A operand, [nvars, B16/16,
      R16/16, 2 (hi, lo), 32, 4]: rows b, k-steps of 16 radii;
    * ``az``: analysis_z as the vertical stage's B operand, [nvars, Z16/16,
      Z8/8, 32, 4]: k-steps of 16 levels z, n-tiles of 8 coefficients K.

    ``nvars``: the variables an and az hold; the kernel's variable v reads
    v % nvars (the vmap rule's members share them)."""

    la: torch.Tensor
    an: torch.Tensor
    az: torch.Tensor
    nvars: int


def _bf16_pairs(v: torch.Tensor) -> torch.Tensor:
    """bf16-valued float32 [..., 2n] -> int32 [..., n]: two bf16 a word,
    the even index in the low half."""
    bits = v.contiguous().to(torch.bfloat16).view(torch.int16)
    lo = bits[..., 0::2].to(torch.int32) & 0xFFFF
    return lo | (bits[..., 1::2].to(torch.int32) << 16)


def _padded(op: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    out = op.new_zeros(op.shape[:-2] + (rows, cols))
    out[..., :op.shape[-2], :op.shape[-1]] = op
    return out


def _pack_b(op: torch.Tensor, lambda_order: bool) -> torch.Tensor:
    """[..., N, K] (N outputs, K contracted; bf16 values) as an m16n8k16 B
    operand: [..., K16/16, N8/8, 32, 2]; within a k-step, register r and
    half e of lane (g, t) hold K index 8 r + 2 t + e, or with
    ``lambda_order`` t + 4 e + 8 r."""
    n, k = _up(op.shape[-2], 8), _up(op.shape[-1], 16)
    m = _padded(op, n, k)
    lead = m.shape[:-2]
    d = len(lead)
    if lambda_order:  # K = ks, r, e, t
        m = m.reshape(*lead, n // 8, 8, k // 16, 2, 2, 4)
        m = m.permute(*range(d), d + 2, d, d + 1, d + 5, d + 3, d + 4)
    else:  # K = ks, r, t, e
        m = m.reshape(*lead, n // 8, 8, k // 16, 2, 4, 2)
        m = m.permute(*range(d), d + 2, d, d + 1, d + 4, d + 3, d + 5)
    # [..., ks, nt, g, t, r, e] -> pairs over e
    return _bf16_pairs(m.reshape(*lead, k // 16, n // 8, 32, 4))


def _pack_a(op: torch.Tensor) -> torch.Tensor:
    """[..., M, K] (bf16 values) as an m16n8k16 A operand: [..., M16/16,
    K16/16, 32, 4]; register (c, h) = 2 c + h of lane (g, t) holds row 8 h +
    g, K index 8 c + 2 t + e."""
    mm, k = _up(op.shape[-2], 16), _up(op.shape[-1], 16)
    m = _padded(op, mm, k)
    lead = m.shape[:-2]
    d = len(lead)
    m = m.reshape(*lead, mm // 16, 2, 8, k // 16, 2, 4, 2)  # mt, h, g, ks, c, t, e
    m = m.permute(*range(d), d, d + 3, d + 2, d + 5, d + 4, d + 1, d + 6)
    return _bf16_pairs(m.reshape(*lead, mm // 16, k // 16, 32, 8))


def pack_comp_operators(l_analysis, analysis_r, analysis_z) -> CompOperators:
    """The comp kernel's packing of a compensated grid's [3, ...] stacks
    (O_hi, O_lo, O_hi): each operator's bf16 hi and lo, exact (they are
    bf16 values), in fragment order; see CompOperators."""
    la = torch.cat([_pack_b(l_analysis[p], True) for p in (0, 1)], dim=-1)
    an = torch.stack([_pack_a(analysis_r[p]) for p in (0, 1)], dim=-3)
    az = torch.cat([_pack_b(analysis_z[p], False) for p in (0, 1)], dim=-1)
    return CompOperators(la.contiguous(), an.contiguous(), az.contiguous(),
                         int(analysis_r.shape[1]))


def _versions(*ts):
    return tuple(t._version for t in ts)


def comp_operators(l_analysis, analysis_r, analysis_z) -> CompOperators:
    """The packed form of a compensated grid's operators, made once: it is
    kept on the analysis_r tensor with the operators it was made from and
    their versions, and made again only if one of them changed; raises
    where it would be made inside a CUDA graph capture."""
    kept = getattr(analysis_r, "_rlz_comp_packed", None)
    if kept is not None:
        la, az, versions, packed = kept
        if (la is l_analysis and az is analysis_z
                and versions == _versions(l_analysis, analysis_r, analysis_z)):
            return packed
    if analysis_r.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "the compensated analysis packs its operators inside the capture: a "
            "first-use cost the warm-up step should have paid")
    packed = pack_comp_operators(l_analysis, analysis_r, analysis_z)
    trace.count("rlz_analysis.packs", 1)
    _keep(analysis_r, l_analysis, analysis_z, packed)
    return packed


def _keep(analysis_r, l_analysis, analysis_z, packed):
    analysis_r._rlz_comp_packed = (
        l_analysis, analysis_z, _versions(l_analysis, analysis_r, analysis_z), packed)


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


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel library with this module's entry points declared; a
    launch returns 0 or an error code (``PLAN_ERRORS``, else a
    cudaError_t)."""
    lib = load().lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # x, l_analysis, ring_mask, analysis_r, analysis_z, out; V R L Z B; the
    # plan: KT BT C RC LC ZC ST, threads, smem; stream
    plain = [ptr] * 6 + [i32] * 5 + [i32] * 9 + [ptr]
    # the comp mode: x, the packed l_analysis, ring_mask, the packed
    # analysis_r and analysis_z, out; V R L Z B and the packed operators'
    # variables; the comp plan: KT BT C RC RP LC ST, threads, smem; stream,
    # and the clock marks' buffer (None but in
    # tools/torch_comp_analysis_check.py --profile)
    comp = [ptr] * 6 + [i32] * 6 + [i32] * 9 + [ptr, ptr]
    for name, argtypes in (("scythe_rlz_analysis_f32", plain),
                           ("scythe_rlz_analysis_f64", plain),
                           ("scythe_rlz_analysis_comp", comp),
                           ("scythe_rlz_analysis_max_nz", []),
                           ("scythe_rlz_analysis_max_nl", [])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, i32
    return lib


def _launch(phys, ops, shape, mode):
    V, R, L, Z, B = shape
    if not 1 <= Z <= MAX_NZ or not 1 <= L <= MAX_NL:
        raise ValueError(
            f"the rlz_analysis kernel takes nz <= {MAX_NZ} and nl <= {MAX_NL}; "
            f"got nz = {Z}, nl = {L}"
        )
    if mode == "comp":
        if phys.dtype != torch.float32:
            raise ValueError(f"the comp mode runs in float32, got {phys.dtype}")
        la, mask, an, az = ops
        packed = comp_operators(la, an, az)
        if V % packed.nvars != 0:
            raise ValueError(f"{V} variables do not repeat the operators' {packed.nvars}")
        ops = (packed.la, mask, packed.an, packed.az)
    for t in (phys,) + tuple(ops):
        if not t.is_contiguous():
            raise ValueError("the rlz_analysis kernel needs contiguous tensors")
    p = plan(phys.shape, B, phys.dtype, mode)
    lib = library()
    out = torch.empty((V, B, L, Z), dtype=phys.dtype, device=phys.device)
    ptrs = (phys.data_ptr(), *(o.data_ptr() for o in ops), out.data_ptr())
    with torch.cuda.device(phys.device):
        stream = torch.cuda.current_stream(phys.device).cuda_stream
        if mode == "comp":
            err = lib.scythe_rlz_analysis_comp(
                *ptrs, V, R, L, Z, B, packed.nvars, p.kt, p.bt, p.c, p.rc, p.rp, p.lc,
                p.st, p.threads, p.smem, stream, None,
            )
        else:
            fn = (lib.scythe_rlz_analysis_f32 if phys.dtype == torch.float32
                  else lib.scythe_rlz_analysis_f64)
            err = fn(*ptrs, V, R, L, Z, B, p.kt, p.bt, p.c, p.rc, p.lc, p.zc, p.st,
                     p.threads, p.smem, stream)
    if err != 0:
        msg = PLAN_ERRORS.get(err) or lib.scythe_cuda_error_string(err).decode()
        raise RuntimeError(f"rlz_analysis kernel launch failed: {msg} ({err}); {p}")
    trace.count(f"rlz_analysis.{'comp_' if mode == 'comp' else ''}launches", 1)
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
      repeated along it, one launch for all members (in comp mode on a
      card the members read the grid's packed operators: the kernel's
      variable v reads v % nvars);
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
        an, az = analysis_r.repeat(*rep), analysis_z.repeat(*rep)
        if mode == "comp" and x.device.type == "cuda":
            # the members read the grid's packed operators (v % nvars)
            _keep(an, l_analysis, az, comp_operators(l_analysis, analysis_r, analysis_z))
        out = RLZAnalysisFn.apply(x.reshape(n * V, *x.shape[2:]), l_analysis, ring_mask,
                                  an, az, mode)
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
