"""AI2* vertical column solve: a hand-written CUDA kernel for Hopper and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``scythe_tpu/ops/pallas_semiimplicit.py``
(``fused_column_solve``).  For a batch of vertical columns ``[ncols, nz]``:

    xf = F  x*            (Chebyshev truncation refit of xi*)
    g  = ts' Pxi (Dz x*) - w*,  then g -> [0, 0, g[1:nz-1]]  (BC rows)
    a  = Hinv g           (prefactorized Helmholtz solve)
    w  = S a ;  xi = xf - ts' (Ds a)

``Dz`` is applied to the raw x*, as the TPU kernel does; the einsum path of
``scythe_tpu.timeintegration`` applies it to the refit x*, which composes to
the same operator up to rounding.

Every stage is linear in (x*, w*), so the chain is one matrix:
``[w | xi] = [x* | w*] M^T`` with ``M = compose_column_operator(...)``
([2nz, 2nz], one for each (ts', Hinv) pair, composed once in float64).
``column_operator`` builds a stage's ``ColumnOperator`` from that one M: M
in the run's dtype and device and M packed in the fragment order of
``pack_operator``.  ``apply_column_operator``, the main path's call, applies
it: the kernel (``csrc/column_solve.cu``) on a CUDA device, reading the
packed M on the tensor cores (3xTF32 at f32: a hi/lo split of both
operands, so f32 accuracy, not TF32's; DMMA at f64), and its plain version,
one matmul by M, on the CPU.  The kernel's tiles come from ``plan``:
persistent blocks, one copy of M each, row groups of warps taking
16-column tiles.

What bounds it on an H100: at the moist3d shape (9216 x 48, f32) the call
moves 7.11 MB (x* and w* read, w and xi written, M read: 2.12 us at 3.35
TB/s), and the composed product is 170 MFLOP (1.03 us at the card's
f32-accurate tensor-core rate, 3xTF32: a third of its 495 TFLOP/s dense
TF32), so HBM binds at 2.12 us; at the TC shape (1200 x 24) it is 0.14 us,
also HBM, and launch latency rules.  The kernel source says what the design
does about each fault of the first one;
``tools/torch_column_solve_ablation.py`` times the kernel with parts of its
work left out.

``fused_column_solve`` is the counterpart of the TPU function, with its
five operators and its two modes.  ``mode="plain"`` (the TPU kernel's
``_kernel``): the plain chain for tensors on the CPU; on a CUDA device it
composes and packs them (a few small launches) and launches the kernel.
``mode="comp"``, the default as in the TPU function (its ``_kernel_comp``):
the bf16x3 product, float32 only.  The port's chain is one composed M, so
the comp mode splits the composed M (and the activations [x* | w*]) into
bf16 hi/lo parts, rounded to nearest even, and forms hi·hi + lo·hi + hi·lo
with f32 accumulation: ``column_operator(..., mode="comp")`` packs M's
bf16 split in the bf16 tensor cores' fragment order (``pack_operator(M,
float32, "bf16")``) and the comp kernel, a body of its own on ``mma.sync
m16n8k16`` bf16 (``csrc/column_solve.cu``, its comp section), splits each
16-column tile of the activations once.  Its tiles come from ``plan_comp``:
a block a contiguous range of columns, row groups of warps taking its
16-column tiles, bulk copies in, stores from the registers.  Splitting the
composed M and not the five operators differs from the TPU kernel by
bf16x3-sized rounding (tests/test_torch_column_solve.py holds it at the JAX
test's comp bar).  On the CPU its plain version is the same map in f32
arithmetic (``apply_column_operator_comp_plain``).
Every wrapper checks its inputs and has no fallback: on a CUDA tensor it
launches the kernel or raises.  Both wrappers go through ``ColumnSolveFn``,
a ``torch.autograd.Function`` whose backward is the same kernel on M^T
(``ColumnOperator.packed_T``), whose jvp is the kernel on the tangents and
whose vmap folds members into the columns; a comp operator takes the comp
kernel in each.  Each launch adds 1 to a ``trace`` counter:
``column_solve.launches`` the plain kernel's with M,
``column_solve.backward_launches`` those with M^T,
``column_solve.comp_launches`` and ``column_solve.comp_backward_launches``
the comp kernel's.  ``library`` declares the library's entry points, beside
the call whose argument order they describe.
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
from .bf16x3 import comp_einsum, split_op

# largest nz the kernel takes (column_solve.cu kMaxNz): beyond what fits
# beside the ring, M streams through shared memory in K slabs
MAX_NZ = 128

NUM_SMS = 132  # H100 SXM
SMEM_MAX = 232_448  # dynamic shared memory a block may use on Hopper
BARRIER_BYTES = 256  # the kernel's mbarriers, ahead of M's slab
SMEM_SM = 233_472  # an SM's 228 KiB, of which 1 KiB is reserved a block
REGS_SM = 65_536  # 32-bit registers an SM
MAX_THREADS = 576  # a block (the kernel's launch bounds)
MAX_REGS = 112  # registers a thread may take under them (65536 / 576, in 8s)
MAX_RG = 4  # row groups a block
MAX_ST = 4  # slots in the ring of column tiles
TILE = 16  # columns a tile: one m16 row of tensor-core tiles (the kernel's kTile)

# what the kernel returns when it refuses a plan (column_solve.cu)
PLAN_ERRORS = {
    -1: "shape out of range",
    -2: "tile out of range",
    -3: "shared memory differs from the layout or exceeds 232448 bytes",
}

MODES = ("plain", "comp")

# the comp kernel (column_solve.cu, its comp section)
COMP_MAX_THREADS = 512  # a block (its launch bounds: 128 registers a thread)
COMP_MAX_REGS = 128
COMP_MAX_RG = 8  # row groups a block


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _up8(n: int) -> int:
    return _cdiv(n, 8) * 8


@dataclass(frozen=True)
class Plan:
    """One launch's tiles.  The output [ncols, 2 nz] (w | xi, each half
    padded to a multiple of 8) is cut into column tiles of TILE rows.  A
    row group of N / 16 warps (two 8-wide output tiles a warp) multiplies
    one tile at a time; a block holds ``rg`` row groups and one copy of M.
    Row group r of block b takes tiles b + blocks r, then every (blocks
    rg)-th, through a ring of ``st`` slots of its own.  M is staged
    ``kslab`` deep in K: all of K (resident, once a block) or, with one row
    group, in slabs restaged for every tile.  ``smem``: bytes of dynamic
    shared memory a block, as the kernel lays them out."""

    rg: int
    kslab: int
    st: int
    threads: int
    smem: int
    blocks: int

    def resident(self, nz: int) -> bool:
        return self.kslab == 2 * _up8(nz)


def smem_layout(nz: int, es: int, rg: int, kslab: int, st: int) -> tuple[int, int]:
    """Bytes of (M's slab, the rings) as the kernel lays them out after its
    BARRIER_BYTES: 16-byte fragment slots [kslab/8][N/8][32], then each row
    group's tiles [st][TILE][K + 4] elements, a row [x* | w*]; K = N =
    2 up8(nz)."""
    K = 2 * _up8(nz)
    return (kslab // 8) * (K // 8) * 32 * 16, rg * st * TILE * (K + 4) * es


def plan(ncols: int, nz: int, dtype) -> Plan:
    """The kernel's tiles at this shape; pure Python, the plan's only home
    (cached: the wrapper asks for it on every call).

    * A tile is 16 rows, one row group of N / 16 warps.  On the card, two
      m-tiles a warp and four output tiles a warp measured slower at the
      moist3d shape, and blocks of one N half each at the TC shape.
    * Row groups a block: about the tiles an SM gets (at most 4, and 576
      threads), so an SM holds one copy of M for all of its warps.  M must
      be resident for more than one; else it streams in balanced slabs of an
      even number of K steps.
    * Blocks: as many as are resident on the card at once (shared memory
      and registers), up to one a row group's tile.  The ring holds all of
      a row group's tiles (2 to 4 slots).
    """
    return _plan(int(ncols), int(nz), dtype)


@functools.lru_cache(maxsize=64)
def _plan(ncols: int, nz: int, dtype) -> Plan:
    es = torch.empty((), dtype=dtype).element_size()
    K = 2 * _up8(nz)
    tg = 32 * (K // 16)  # threads a row group
    ntiles = _cdiv(ncols, TILE)

    def layout(rg, st):
        """(kslab, smem): M resident if it fits beside the rings, else (one
        row group) in balanced slabs of an even number of K steps."""
        m_full, rings = smem_layout(nz, es, rg, K, st)
        if BARRIER_BYTES + m_full + rings <= SMEM_MAX:
            return K, BARRIER_BYTES + m_full + rings
        if rg > 1:
            return None
        room = SMEM_MAX - BARRIER_BYTES - rings
        depth = 16 * (room // smem_layout(nz, es, rg, 16, st)[0])
        kslab = 16 * _cdiv(K, 16 * _cdiv(K, depth))
        m, rings = smem_layout(nz, es, rg, kslab, st)
        return kslab, BARRIER_BYTES + m + rings

    rg = max(1, min(MAX_RG, MAX_THREADS // tg, _cdiv(ntiles, NUM_SMS)))
    while layout(rg, 2) is None:
        rg -= 1
    threads = rg * tg

    def spread(smem):
        """(blocks, tiles a row group): all blocks resident at once."""
        per_sm = min(SMEM_SM // (smem + 1024), REGS_SM // (MAX_REGS * threads), 32)
        blocks = max(1, min(_cdiv(ntiles, rg), NUM_SMS * per_sm))
        return blocks, _cdiv(ntiles, blocks * rg)

    st = 2
    kslab, smem = layout(rg, st)
    blocks, tiles = spread(smem)
    # a resident row group keeps all of its tiles in flight, 2 to 4 slots
    deeper = min(MAX_ST, tiles)
    if kslab == K and deeper > st and (layout(rg, deeper) or (0,))[0] == K:
        st = deeper
        kslab, smem = layout(rg, st)
        blocks, tiles = spread(smem)
    return Plan(rg=rg, kslab=kslab, st=st, threads=threads, smem=smem, blocks=blocks)


@dataclass(frozen=True)
class CompPlan:
    """One launch of the comp kernel.  Block b takes the contiguous columns
    [span (b // nsplit), span (b // nsplit + 1)) and, with ``nsplit`` 2, only
    w (b even) or xi (b odd) of them, with that half of M resident; its
    16-column tiles go to ``rg`` row groups of ceil(N / nsplit / 8 / ntw)
    warps (``ntw`` 8-wide output tiles a warp), group r taking tiles r, r +
    rg, ..., one raw tile in flight at a time.  ``smem``: bytes of dynamic
    shared memory a block, as the kernel lays them out."""

    span: int
    nsplit: int
    rg: int
    ntw: int
    threads: int
    smem: int
    blocks: int


def comp_smem_bytes(nz: int, nsplit: int, rg: int) -> int:
    """The comp kernel's shared memory: BARRIER_BYTES, M's part (16-byte
    fragment slots [K / 8 / nsplit][K / 16][32]), then per row group its
    raw tile (x* and w*, [16][nz] f32 each) and its bf16 hi and lo A tiles
    [16][K + 8]."""
    K = 2 * _up8(nz)
    m_bytes = (K // 8 // nsplit) * (K // 16) * 32 * 16
    return BARRIER_BYTES + m_bytes + rg * (2 * TILE * nz * 4 + 2 * TILE * (K + 8) * 2)


# the comp plan's cost model, fitted to the comp body's clock64 marks on an
# H100 (PERF.md §6): a queued launch ~1.7 us; a block's set-up and its
# first copies' landing ~1,700 clocks; then per tile of a row group the split
# pass (~250 clocks and ~120 a quad of K a thread), the products (a warp's
# 16-deep K steps at ~100 clocks and ~25 an output tile each, or the SM's
# tensor cores at ~10 clocks an m16n8k16 over its 4 sub-partitions, whichever
# is longer) and the outputs (~500); HBM at 3.35 TB/s for the card, ~1/66 of
# it for one SM; ~1.9 GHz
COMP_CLOCK_GHZ = 1.9
COMP_LAUNCH_US = 1.7
COMP_SETUP_CLOCKS = 1700
HBM_GB_S = 3350.0
SM_GB_S = HBM_GB_S / 66


def comp_cost_us(ncols: int, nz: int, p: CompPlan) -> float:
    """The comp kernel's time at this plan by the model above: launch, then
    the larger of the HBM time (the card's, and the busiest SM's share: its
    columns in and its outputs out, a read of the other N part's columns
    counted as from HBM) and the busiest block's clocks (set-up, then its
    row groups' tiles one after another, the groups side by side)."""
    K = 2 * _up8(nz)
    nb8 = K // 8 // p.nsplit
    warps = _cdiv(nb8, p.ntw)
    tg = 32 * warps
    cols = min(p.span, ncols)
    tiles = _cdiv(cols, TILE)
    per_group = _cdiv(tiles, p.rg)
    col_bytes = nz * 4 * (2 + 2 / p.nsplit)
    t_hbm = max(ncols * p.nsplit * col_bytes / (HBM_GB_S * 1e3),
                cols * col_bytes / (SM_GB_S * 1e3))
    ks = K // 16
    split = 250 + 120 * _cdiv(TILE * K // 4, tg)
    chain = ks * (100 + 25 * p.ntw)
    tensor = 10 * min(p.rg, tiles) * warps * ks * p.ntw * 3 / 4
    clocks = COMP_SETUP_CLOCKS + per_group * (split + max(chain, tensor) + 500)
    return COMP_LAUNCH_US + max(t_hbm, clocks / (COMP_CLOCK_GHZ * 1e3))


def plan_comp(ncols: int, nz: int) -> CompPlan:
    """The comp kernel's tiles at this shape; pure Python, the plan's only
    home (cached).

    * N whole or halved (nsplit 1 or 2; halved where M does not fit
      beside a row group).
    * A block's columns: a multiple of 4, so every tile but the very last
      is whole 16-byte units for the bulk copies, over at most 132 / nsplit
      ranges, so no SM moves more than 4 columns over its share (the tail
      16-column tiles would leave: 576 tiles over 132 SMs at 9216 columns).
    * ntw 2 or 4 output tiles a warp (the last warp of a group may have
      fewer).
    * Row groups: up to one a tile of the block, within 512 threads and
      shared memory.
    Of the plans that fit, the one ``comp_cost_us`` ranks first."""
    return _plan_comp(int(ncols), int(nz))


@functools.lru_cache(maxsize=64)
def _plan_comp(ncols: int, nz: int) -> CompPlan:
    K = 2 * _up8(nz)
    quads = _cdiv(ncols, 4)
    best, best_cost = None, None
    for nsplit, ntw in itertools.product((1, 2), (4, 2)):
        nb8 = K // 8 // nsplit
        tg = 32 * _cdiv(nb8, ntw)
        span = 4 * _cdiv(quads, NUM_SMS // nsplit)
        tiles = _cdiv(min(span, ncols), TILE)
        for rg in range(1, min(COMP_MAX_RG, tiles, COMP_MAX_THREADS // tg) + 1):
            smem = comp_smem_bytes(nz, nsplit, rg)
            if smem > SMEM_MAX:
                break
            p = CompPlan(span=span, nsplit=nsplit, rg=rg, ntw=ntw, threads=rg * tg, smem=smem,
                         blocks=nsplit * _cdiv(ncols, span))
            cost = comp_cost_us(ncols, nz, p)
            if best is None or cost < best_cost:
                best, best_cost = p, cost
    return best


def compose_column_operator(F, Dz, Hinv, S, Ds, ts_term, pxi_bar) -> torch.Tensor:
    """The chain as one [2nz, 2nz] matrix M, ``[w | xi] = [x* | w*] M^T``.

    With P the BC shift (P[j, j-1] = 1 for j >= 2, zero elsewhere), HP =
    Hinv P and HD = ts' HP diag(Pxi) Dz (``pxi_bar`` a scalar or an [nz]
    profile, which scales the rows of Dz, as the JAX einsum path broadcasts
    it over the output z axis):

        rows of w:  [ S HD,          -S HP      ]
        rows of xi: [ F - ts' Ds HD,  ts' Ds HP ]

    Computed in the operators' dtype (build_semiimplicit_ops passes
    float64) on their device."""
    F, Dz, Hinv, S, Ds = (torch.as_tensor(o) for o in (F, Dz, Hinv, S, Ds))
    nz = F.shape[0]
    j = torch.arange(2, nz, device=F.device)
    P = torch.zeros_like(F)
    P[j, j - 1] = 1.0
    hp = Hinv @ P
    pxi = torch.as_tensor(pxi_bar, dtype=F.dtype, device=F.device).reshape(-1, 1)
    hd = ts_term * (hp @ (pxi * Dz))
    w_rows = torch.cat([S @ hd, -(S @ hp)], dim=1)
    xi_rows = torch.cat([F - ts_term * (Ds @ hd), ts_term * (Ds @ hp)], dim=1)
    return torch.cat([w_rows, xi_rows], dim=0)


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as the kernel's tf32_bits: to nearest, ties
    away from zero, the low 13 mantissa bits cleared (cvt.rna.tf32.f32)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def pack_operator(M: torch.Tensor, dtype, split: str = "tf32") -> torch.Tensor:
    """M [2nz, 2nz] in the order the kernel's tensor-core fragments read it,
    one 16-byte slot a lane (K = 2 up8(nz), each half of M zero-padded to
    up8(nz)).

    ``split`` "tf32" (the plain kernel): [K/8, K/8, 32, 2] float64 or
    [K/8, K/8, 32, 4] float32, indexed [k-step kb, output tile nt, lane g*4
    + t] -> M[8 nt + g][8 kb + t] and M[8 nt + g][8 kb + 4 + t] (m16n8k8's B
    fragment); at float32 those two as hi = tf32_round(v) and then lo =
    tf32_round(v - hi), v = float32(M), split once here.

    ``split`` "bf16" (the comp kernel, float32 only): [K/8, K/16, 32, 8]
    bfloat16, n-tile major (a block of the kernel reads a contiguous run of
    output tiles), indexed [output tile nt, k-step ks, lane g*4 + t] -> M's
    row n = 8 nt + g at k = 16 ks + (2t, 2t + 1, 2t + 8, 2t + 9) (m16n8k16's
    B fragment b0, b1: two bf16 pairs), their hi = bf16(v), then their lo =
    bf16(v - hi), each rounded to nearest even, as the TPU kernel's _split
    (astype) and __float2bfloat16_rn.  K is a multiple of 16, so no padding
    beyond the halves'; where up8(nz) is an odd multiple of 8 a 16-deep
    step spans both halves, the padded layout the kernel's A tiles share."""
    nz = M.shape[0] // 2
    kh = _up8(nz)
    nt = 2 * kh // 8
    idx = torch.cat([torch.arange(nz), kh + torch.arange(nz)]).to(M.device)
    mp = torch.zeros((2 * kh, 2 * kh), dtype=torch.float64, device=M.device)
    mp[idx[:, None], idx[None, :]] = M.to(torch.float64)
    if split == "bf16":
        if dtype != torch.float32:
            raise ValueError(f"the comp mode runs in float32, got {dtype}")
        v = mp.to(torch.float32)
        hi = v.to(torch.bfloat16)
        lo = (v - hi.to(torch.float32)).to(torch.bfloat16)
        # n = 8 nt + g, k = 16 ks + 8 h + 2 t + e  ->  [nt, ks, g, t, h, e]
        frags = [o.view(nt, 8, nt // 2, 2, 4, 2).permute(0, 2, 1, 4, 3, 5).reshape(
            nt, nt // 2, 32, 4) for o in (hi, lo)]
        return torch.cat(frags, dim=-1).contiguous()
    # n = 8 nt + g, k = 8 kb + 4 h + t  ->  [kb, nt, g, t, h]
    frag = mp.view(nt, 8, nt, 2, 4).permute(2, 0, 1, 4, 3).reshape(nt, nt, 32, 2)
    if dtype == torch.float64:
        return frag.contiguous()
    v = frag.to(torch.float32)
    hi = tf32_round(v)
    return torch.cat([hi, tf32_round(v - hi)], dim=-1).contiguous()


class ColumnOperator(NamedTuple):
    """One stage's chain as one operator, made by ``column_operator`` from
    one M: ``M`` [2nz, 2nz] in the run's dtype and device, which the plain
    version applies on the CPU; ``packed``, pack_operator of the same M,
    which the kernel reads on a CUDA device; and ``packed_T``, pack_operator
    of M^T, which the kernel reads for the backward (the cotangents of
    [w | xi] times M are those of [x* | w*]).  An operator built without
    ``packed_T`` runs forward on the card, and its backward there raises.
    ``comp``: the bf16x3 product (packings of M's bf16 split; float32)."""

    M: torch.Tensor
    packed: torch.Tensor
    packed_T: torch.Tensor | None = None
    comp: bool = False


def column_operator(m64: torch.Tensor, dtype, device, mode: str = "plain") -> ColumnOperator:
    """A stage's ColumnOperator from its float64 M (compose_column_operator),
    with the packed transpose its backward reads; ``mode`` "plain" or "comp"
    (float32 only)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    comp = mode == "comp"
    if comp and dtype != torch.float32:
        raise ValueError(f"the comp mode runs in float32, got {dtype}")
    split = "bf16" if comp else "tf32"
    return ColumnOperator(
        M=m64.to(dtype=dtype, device=device),
        packed=pack_operator(m64, dtype, split).to(device),
        packed_T=pack_operator(m64.T, dtype, split).to(device),
        comp=comp,
    )


def fused_column_solve_plain(xstar, wstar, F, Dz, Hinv, S, Ds, ts_term, pxi_bar):
    """The chain in plain PyTorch ([ncols, nz] @ operator^T per stage);
    ``pxi_bar`` a scalar or an [nz] profile over the z axis."""
    xf = xstar @ F.T
    if not isinstance(pxi_bar, float | int):
        pxi_bar = torch.as_tensor(pxi_bar, dtype=xstar.dtype, device=xstar.device)
    g = (ts_term * pxi_bar) * (xstar @ Dz.T) - wstar
    g = torch.cat([g.new_zeros(g.shape[0], 2), g[:, 1:-1]], dim=1)
    a = g @ Hinv.T
    return a @ S.T, xf - ts_term * (a @ Ds.T)


def apply_column_operator_plain(xstar, wstar, M):
    """[w | xi] = [x* | w*] M^T in plain PyTorch: one matmul."""
    nz = xstar.shape[1]
    out = torch.cat([xstar, wstar], dim=1) @ M.T
    return out[:, :nz].contiguous(), out[:, nz:].contiguous()


def apply_column_operator_comp_plain(xstar, wstar, M):
    """The comp kernel's function in plain PyTorch: [w | xi] = [x* | w*] M^T
    as the bf16x3 product (M and [x* | w*] each split into bf16 hi/lo, the
    three products hi·hi + lo·hi + hi·lo summed in float32)."""
    nz = xstar.shape[1]
    out = comp_einsum("nk,ck->cn", split_op(M), torch.cat([xstar, wstar], dim=1))
    return out[:, :nz].contiguous(), out[:, nz:].contiguous()


def _check(xstar, wstar, ops, side) -> tuple[int, int]:
    """(ncols, nz) of [ncols, nz] x* and w*; the (name, tensor) pairs of
    ``ops`` must be [side nz, side nz], all in x*'s dtype on its device."""
    if xstar.ndim != 2 or wstar.shape != xstar.shape:
        raise ValueError(
            f"x* and w* must both be [ncols, nz]; got {tuple(xstar.shape)} "
            f"and {tuple(wstar.shape)}"
        )
    ncols, nz = xstar.shape
    if ncols < 1:
        raise ValueError("the column solve needs at least one column")
    if not 3 <= nz <= MAX_NZ:
        raise ValueError(
            f"the column solve supports 3 <= nz <= {MAX_NZ}, got nz = {nz}"
        )
    if xstar.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {xstar.dtype}")
    if xstar.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"the column solve runs on cpu or cuda tensors, got {xstar.device}"
        )
    for name, t in (("w*", wstar),) + tuple(ops):
        if t.dtype != xstar.dtype or t.device != xstar.device:
            raise ValueError(
                f"{name} is {t.dtype} on {t.device}; x* is {xstar.dtype} on "
                f"{xstar.device}"
            )
    for name, t in ops:
        if tuple(t.shape) != (side * nz, side * nz):
            raise ValueError(
                f"{name} must be [{side * nz}, {side * nz}], got {tuple(t.shape)}"
            )
    for _, t in (("x*", xstar), ("w*", wstar)) + tuple(ops):
        if not t.is_contiguous():
            raise ValueError("the column solve needs contiguous tensors")
    return ncols, nz


# scythe_column_solve_f32 / _f64: x, w, packed M, w_out, xi_out; ncols nz;
# the plan (plan): RG KSLAB ST, threads, smem, blocks; stream
COLUMN_SOLVE_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
# scythe_column_solve_comp: the same but its plan (plan_comp): SPAN NSPLIT
# RG NTW, threads, smem, blocks
COLUMN_SOLVE_COMP_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel library with this module's entry points declared; each
    returns 0 or an error code (``PLAN_ERRORS``, else a cudaError_t)."""
    lib = load().lib
    for name, argtypes in (("scythe_column_solve_f32", COLUMN_SOLVE_ARGTYPES),
                           ("scythe_column_solve_f64", COLUMN_SOLVE_ARGTYPES),
                           ("scythe_column_solve_comp", COLUMN_SOLVE_COMP_ARGTYPES),
                           ("scythe_column_solve_max_nz", [])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def _launch(xstar, wstar, packed, transposed=False, comp=False):
    """One kernel launch: [out1 | out2] = [xstar | wstar] A^T for the
    operator A whose packing is ``packed`` (M forward, M^T backward); the
    comp kernel for a comp operator."""
    if packed is None:
        raise ValueError(
            "the column solve's backward needs the operator's packed transpose "
            "(ColumnOperator.packed_T, which column_operator builds)"
        )
    ncols, nz = xstar.shape
    nt = 2 * _up8(nz) // 8
    if comp and xstar.dtype != torch.float32:
        raise ValueError(f"the comp mode runs in float32, got {xstar.dtype}")
    if comp:
        want, want_dtype, split = (nt, nt // 2, 32, 8), torch.bfloat16, ', "bf16"'
    else:
        want = (nt, nt, 32, 4 if xstar.dtype == torch.float32 else 2)
        want_dtype, split = xstar.dtype, ""
    if (tuple(packed.shape) != want or packed.dtype != want_dtype
            or packed.device != xstar.device or not packed.is_contiguous()):
        raise ValueError(
            f"packed must be pack_operator(M, {xstar.dtype}{split}) on {xstar.device}, "
            f"{want_dtype} {list(want)}; got {packed.dtype} {list(packed.shape)} on "
            f"{packed.device}"
        )
    lib = library()
    if comp:
        p = plan_comp(ncols, nz)
        fn = lib.scythe_column_solve_comp
        fields = (p.span, p.nsplit, p.rg, p.ntw, p.threads, p.smem, p.blocks)
    else:
        p = plan(ncols, nz, xstar.dtype)
        fn = lib.scythe_column_solve_f32 if xstar.dtype == torch.float32 else (
            lib.scythe_column_solve_f64)
        fields = (p.rg, p.kslab, p.st, p.threads, p.smem, p.blocks)
    w_out = torch.empty_like(xstar)
    xi_out = torch.empty_like(xstar)
    with torch.cuda.device(xstar.device):
        stream = torch.cuda.current_stream(xstar.device).cuda_stream
        err = fn(
            xstar.data_ptr(), wstar.data_ptr(), packed.data_ptr(),
            w_out.data_ptr(), xi_out.data_ptr(), ncols, nz, *fields, stream,
        )
    if err != 0:
        msg = PLAN_ERRORS.get(err) or lib.scythe_cuda_error_string(err).decode()
        raise RuntimeError(f"column_solve kernel launch failed: {msg} ({err}); {p}")
    kind = ("comp_" if comp else "") + ("backward_launches" if transposed else "launches")
    trace.count(f"column_solve.{kind}", 1)
    return w_out, xi_out


class ColumnSolveFn(torch.autograd.Function):
    """The column solve as a differentiable operation: (a, b) -> [a | b] A^T
    for the stage's operator A (M, or M^T in a backward), on the CPU its
    plain matmul, on a CUDA device the kernel; every rule below runs on both
    devices the same way, so the CPU tests check the formulas the card uses.

    * backward: the map is linear, so the cotangents of (out1, out2) times A
      are those of (a, b): the same Function with A^T (``packed_T`` on the
      card; on the CPU the view M.T), one more kernel launch, counted in
      ``column_solve.backward_launches``;
    * jvp: the same launch on the tangents;
    * vmap: the batch is folded into the columns, one launch for all members.

    ``comp`` (a comp operator's) takes the comp kernel, or its plain version
    on the CPU, in each rule: the backward is the comp kernel on the split
    of M^T.

    A and its packings get no gradient: the Helmholtz operator is built from
    the reference state at its static values, as the JAX package bakes it
    into its step (scythe_tpu/adjoint.py, make_simulator's caveats)."""

    generate_vmap_rule = False

    @staticmethod
    def forward(a, b, M, packed, M_T, packed_T, transposed, comp):
        if a.device.type == "cpu":
            plain = apply_column_operator_comp_plain if comp else apply_column_operator_plain
            return plain(a, b, M)
        if a.device.type != "cuda":
            raise ValueError(f"the column solve runs on cpu or cuda tensors, got {a.device}")
        return _launch(a.contiguous(), b.contiguous(), packed, transposed, comp)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, _, M, packed, M_T, packed_T, transposed, comp = inputs
        ctx.transposed = transposed
        ctx.comp = comp
        # packed_T is None where an operator was built without it
        ctx.save_for_backward(M, packed, M_T, packed_T)
        ctx.save_for_forward(M, packed, M_T, packed_T)

    @staticmethod
    def backward(ctx, g1, g2):
        M, packed, M_T, packed_T = ctx.saved_tensors
        ga, gb = ColumnSolveFn.apply(g1, g2, M_T, packed_T, M, packed, not ctx.transposed,
                                     ctx.comp)
        return ga, gb, None, None, None, None, None, None

    @staticmethod
    def jvp(ctx, a_t, b_t, *_):
        M, packed, M_T, packed_T = ctx.saved_tensors
        a_t = torch.zeros_like(b_t) if a_t is None else a_t
        b_t = torch.zeros_like(a_t) if b_t is None else b_t
        return ColumnSolveFn.apply(a_t, b_t, M, packed, M_T, packed_T, ctx.transposed,
                                   ctx.comp)

    @staticmethod
    def vmap(info, in_dims, a, b, M, packed, M_T, packed_T, transposed, comp):
        if any(d is not None for d in in_dims[2:]):
            raise NotImplementedError(
                "the column solve applies one operator to every member; its "
                "operator cannot carry a batch dimension"
            )
        n = info.batch_size

        def fold(t, d):
            t = t.movedim(d, 0) if d is not None else t.expand(n, *t.shape)
            return t.reshape(-1, t.shape[-1])

        out = ColumnSolveFn.apply(fold(a, in_dims[0]), fold(b, in_dims[1]), M, packed,
                                  M_T, packed_T, transposed, comp)
        return tuple(o.reshape(n, -1, o.shape[-1]) for o in out), (0, 0)


def apply_column_operator(xstar, wstar, op: ColumnOperator):
    """Apply a stage's operator to [ncols, nz] column batches x* (xi*) and
    w*; returns (w_new, xi_new), through ColumnSolveFn: the kernel on a CUDA
    device (op.packed; op.packed_T for its backward), its plain version on
    the CPU (op.M): both from the one M; a comp operator's in comp mode."""
    _check(xstar, wstar, (("M", op.M),), 2)
    if op.comp and xstar.dtype != torch.float32:
        raise ValueError(f"the comp mode runs in float32, got {xstar.dtype}")
    return ColumnSolveFn.apply(xstar, wstar, op.M, op.packed, op.M.T, op.packed_T, False,
                               op.comp)


def fused_column_solve(xstar, wstar, F, Dz, Hinv, S, Ds, ts_term, pxi_bar, mode="comp"):
    """The TPU function's counterpart: apply the chain to [ncols, nz] column
    batches; returns (w_new, xi_new).  Argument order as the TPU kernel's:
    x* (xi*) first.  ``Hinv`` is the inverse of the BC-row-shuffled
    Helmholtz matrix (timeintegration.helmholtz_matrix); ``ts_term`` is a
    scalar, ``pxi_bar`` a scalar or an [nz] profile (the TPU kernel takes a
    scalar only).  ``mode`` as the TPU function's, "comp" by default: the
    bf16x3 product of the composed M, float32 only (the module docstring);
    "plain": f32 or f64.  In plain mode the plain chain on the CPU (autograd
    differentiates it as it stands); otherwise, and on a CUDA device, the
    operators are composed in float64 and packed with their transpose (a
    few small launches), then the kernel, or on the CPU its plain version,
    runs through ColumnSolveFn, as the main path's apply_column_operator.
    The main path composes once per stage instead."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    ops = (F, Dz, Hinv, S, Ds)
    _check(xstar, wstar, tuple(zip(("F", "Dz", "Hinv", "S", "Ds"), ops)), 1)
    if mode == "plain" and xstar.device.type == "cpu":
        return fused_column_solve_plain(xstar, wstar, *ops, ts_term, pxi_bar)
    M = compose_column_operator(*(o.detach().double() for o in ops), ts_term, pxi_bar)
    return apply_column_operator(
        xstar, wstar, column_operator(M, xstar.dtype, xstar.device, mode))
