"""Copied verbatim from ``scythe_tpu.parallel.schur`` (numpy only, so the port
can import it without jax); tests/test_torch_schur.py pins every array it
builds equal to the original.

Exact distributed radial spline solve via banded Schur complement.

Round-1 built the sharded analysis as: local quadrature projection, one
``psum`` of the FULL ``[nvars, b_rDim, ...]`` projection, and a replicated
Gram/filter/BC solve with replicated spectral state.  Exact, but per-step
communication and per-chip spectral memory are O(global spectral) — the
wrong shape for a pod (round-1 VERDICT missing #2).

This module implements the scalable exact path.  The constrained-basis
normal matrix ``M = gram + eps*penalty`` (basis/bspline.py) is banded with
half-bandwidth 3 (cubic B-splines only overlap 3 neighbors; the
third-derivative penalty has the same support), so the global solve admits
an exact block factorization — substructuring / Schur complement:

* partition the constrained unknowns into per-shard blocks; take the 3
  unknowns at each inter-shard cut as "separators" (the algebraic analog of
  the reference's 3-coefficient halo slabs, src/semiimplicit.jl:84-86,
  320-329);
* interiors of different shards then do not couple (gap 4 > bandwidth 3),
  so interior elimination is embarrassingly shard-local with precomputed
  dense inverses;
* the eliminated interface system S (3 unknowns per cut) is tiny; its
  inverse is precomputed and the interface solve is a [6, 3n] matvec per
  shard.

Everything is precomputed in float64 numpy at build time and composed into
FIVE per-shard runtime matrices, so the runtime distributed solve is just

    g    = GL_i @ p_own                       (local)
    g   += ppermute(GRr_{i-1} @ p_own, right) (3-row slab, the only
                                               neighbor exchange)
    c6   = CS_i @ all_gather(g)               (3 rows per shard gathered)
    a    = AP_i @ p_own + AC_i @ c6           (local back-substitution)

Per-step comm: two 3-row ppermutes + one 3-row-per-shard all_gather —
O(halo), not O(spectral) — and each shard holds only its own coefficient
window, never the full spectral array.  The result is EXACTLY the global
filtered least-squares analysis (same linear system, different elimination
order), verified to 1e-12 against the dense path in tests/test_schur.py.

For shard counts past O(10), the interface gather itself becomes the O(n)
term; ``build_pcr_ops`` replaces it with distributed parallel cyclic
reduction of the block-tridiagonal interface system — O(log n) ppermutes
of 3-row slabs, and measured <= 3 levels for ANY n (the B-spline interface
Schur complement is strongly diagonally dominant, so couplings decay
quadratically per level): per-chip interface communication is O(1) in
practice.  Exact for non-periodic partitions and power-of-two cyclic ones;
convergent to machine roundoff otherwise (asserted at build time).
Selected via ``interface="pcr"`` (auto at n >= 16) in parallel/sharding.py.

Layout: the per-shard spectral state is the raw-coefficient "window"
``[i*cl, i*cl + cl + 3)`` (owned rows + 3 halo rows duplicating the right
neighbor's first owned rows; cyclic for the last shard).  The window is
exactly the coefficient support of the shard's own physical points, so
sharded SYNTHESIS needs no communication at all.

PERIODIC grids wrap naturally: the raw->constrained fold (T) routes the
wrap contributions onto cut 0, which rides the same cyclic ppermute.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..basis import bspline
from ..basis.bspline import BC
from ..config import GridParameters

HALO = 3  # B-spline half-bandwidth == halo rows, ref semiimplicit.jl:84-86


@dataclass(frozen=True)
class SchurOps:
    """Per-shard stacked runtime matrices (numpy float64).

    Shapes: n = shards, v = nvars, W = cells_per_shard + 3 (window),
    I = padded interior size (= cells_per_shard).
    """

    n: int
    cl: int  # cells per shard
    W: int  # window rows = cl + 3
    GL: np.ndarray  # [n, v, 3, W]   p_own -> own-cut interface partial
    GRr: np.ndarray  # [n, v, 3, W]  p_own -> right-cut partial (ppermuted)
    CS: np.ndarray | None  # [n, v, 6, 3n] gathered interface RHS ->
    # (c_l, c_r); None when built with include_cs=False (PCR interface)
    AP: np.ndarray  # [n, v, W, W]   p_own -> owned raw coeff rows (direct)
    AC: np.ndarray  # [n, v, W, 6]   cut solution -> owned raw coeff rows


def _index_sets(K: int, n: int, cl: int, d_l: int, periodic: bool):
    """Separator/interior constrained-index sets per shard.

    Returns (seps, ints): lists of n integer arrays.  seps[k] are the 3
    unknowns of cut k (cut k sits at the left edge of shard k; cut 0 is
    empty for non-periodic grids)."""
    if periodic:
        seps = [(k * cl - 1 + np.arange(3)) % K for k in range(n)]
        ints = [np.arange(k * cl + 2, (k + 1) * cl - 1) for k in range(n)]
    else:
        seps = [np.array([], dtype=int)] + [
            np.arange(k * cl - d_l, k * cl - d_l + 3) for k in range(1, n)
        ]
        s = [k * cl - d_l for k in range(1, n)]
        ints = [np.arange(0, s[0])]
        for k in range(1, n - 1):
            ints.append(np.arange(s[k - 1] + 3, s[k]))
        ints.append(np.arange(s[n - 2] + 3, K))
    cover = np.concatenate(seps + ints)
    assert len(cover) == K and len(np.unique(cover)) == K, "index sets must tile"
    return seps, ints


def _pad(a: np.ndarray, rows: int, cols: int) -> np.ndarray:
    out = np.zeros((rows, cols))
    out[: a.shape[0], : a.shape[1]] = a
    return out


def _check_partition(p: GridParameters, n: int) -> int:
    nc = p.num_cells
    if n < 2:
        raise ValueError("Schur path needs >= 2 shards")
    if nc % n != 0:
        raise ValueError(f"num_cells={nc} not divisible by {n} shards")
    cl = nc // n
    if cl < 4:
        raise ValueError(f"need >= 4 cells per shard, got {cl}")
    return cl


def _var_interface(p: GridParameters, v: int, n: int, cl: int):
    """Per-variable partition + eliminated interface system.

    Returns ``(ops, seps, ints, s_pos, S_ext)`` where ``S_ext`` is the
    block-tridiagonal (cyclic for PERIODIC) [3n, 3n] interface Schur
    complement with cut k at rows 3k..3k+2; absent cuts (cut 0 of
    non-periodic grids) are identity rows."""
    ops = bspline.build_ops(p.xmin, p.xmax, p.num_cells, p.BCL[v], p.BCR[v], p.l_q)
    T, M = ops.T, ops.mmat
    K = T.shape[1]
    periodic = p.BCL[v] == BC.PERIODIC
    d_l = 0 if periodic else (3 - {
        BC.R0: 3, BC.R1T0: 2, BC.R1T1: 2, BC.R1T2: 2,
        BC.R2T10: 1, BC.R2T20: 1, BC.R3: 0,
    }[p.BCL[v]])
    seps, ints = _index_sets(K, n, cl, d_l, periodic)

    # global interface numbering: cut k -> rows 3k..3k+2
    Sall = np.concatenate(seps)
    s_pos = {}  # constrained index -> global interface row
    for k in range(n):
        for j, c in enumerate(seps[k]):
            s_pos[c] = 3 * k + j

    # interface Schur complement over present cuts, embedded in [3n,3n]
    Iall = np.concatenate(ints)
    Aii = M[np.ix_(Iall, Iall)]
    # interiors of different shards must not couple (bandwidth check)
    off = 0
    for k in range(n):
        sz = len(ints[k])
        blk = Aii[off : off + sz, :]
        outside = np.delete(blk, np.s_[off : off + sz], axis=1)
        assert np.all(outside == 0.0), "interior blocks must decouple"
        off += sz
    Ssub = M[np.ix_(Sall, Sall)] - M[np.ix_(Sall, Iall)] @ np.linalg.solve(
        Aii, M[np.ix_(Iall, Sall)]
    )
    S_ext = np.eye(3 * n)
    rows = np.array([s_pos[c] for c in Sall])
    S_ext[np.ix_(rows, rows)] = Ssub
    return ops, seps, ints, s_pos, S_ext


def var_interfaces(params: GridParameters, n: int) -> list:
    """Per-variable ``_var_interface`` results, computed once so HaloOps can
    share the (expensive) interior eliminations between ``build_schur_ops``
    and ``build_pcr_ops``."""
    cl = _check_partition(params, n)
    return [_var_interface(params, v, n, cl) for v in range(params.nvars)]


def build_schur_ops(
    params: GridParameters,
    n: int,
    ifaces: list | None = None,
    include_cs: bool = True,
) -> SchurOps:
    """Precompute the distributed-solve matrices for ``n`` radial shards.

    ``include_cs=False`` skips the dense interface inverse and the
    [n, v, 6, 3n] CS array (O(n^2) memory) — used when the runtime solves
    the interface by PCR instead of gather+matvec."""
    p = params
    nc, nb = p.num_cells, p.b_rDim
    cl = _check_partition(p, n)
    W = cl + HALO
    Imax = cl
    nv = p.nvars

    GL = np.zeros((n, nv, 3, W))
    GRr = np.zeros((n, nv, 3, W))
    CS = np.zeros((n, nv, 6, 3 * n)) if include_cs else None
    AP = np.zeros((n, nv, W, W))
    AC = np.zeros((n, nv, W, 6))

    if ifaces is None:
        ifaces = var_interfaces(p, n)
    for v in range(nv):
        ops, seps, ints, s_pos, S_ext = ifaces[v]
        T, M = ops.T, ops.mmat
        S_inv = np.linalg.inv(S_ext) if include_cs else None

        for i in range(n):
            sep_i, int_i = seps[i], ints[i]
            sep_r = seps[(i + 1) % n]
            owned = np.arange(i * cl, (i + 1) * cl) if i < n - 1 else np.arange(
                (n - 1) * cl, nb
            )
            Q = T[owned, :].T  # [K, owned] fold of this shard's raw rows
            # locality check: this shard's projections reach only its own
            # separator/interior and (wrap) the next separator
            reach = np.where(np.any(Q != 0.0, axis=1))[0]
            allowed = set(sep_i) | set(int_i) | set(sep_r)
            assert set(reach) <= allowed, "projection fold must be local"

            QS = _pad(Q[sep_i, :], 3, W) if len(sep_i) else np.zeros((3, W))
            QI = _pad(Q[int_i, :], Imax, W)
            Qnext = _pad(Q[sep_r, :], 3, W) if len(sep_r) else np.zeros((3, W))

            Aii_inv = np.linalg.inv(M[np.ix_(int_i, int_i)])
            Y = np.zeros((Imax, W))
            Y[: len(int_i)] = Aii_inv @ QI[: len(int_i)]

            Msi = _pad(M[np.ix_(sep_i, int_i)], 3, Imax) if len(sep_i) else np.zeros(
                (3, Imax)
            )
            Msr = _pad(M[np.ix_(sep_r, int_i)], 3, Imax) if len(sep_r) else np.zeros(
                (3, Imax)
            )
            GL[i, v] = QS - Msi @ Y
            GRr[i, v] = Qnext - Msr @ Y

            if include_cs:
                rows_i = np.array([s_pos[c] for c in sep_i], dtype=int)
                rows_r = np.array([s_pos[c] for c in sep_r], dtype=int)
                cs = np.zeros((6, 3 * n))
                if len(rows_i):
                    cs[0:3] = S_inv[rows_i, :]
                if len(rows_r):
                    cs[3:6] = S_inv[rows_r, :]
                CS[i, v] = cs

            E = M[np.ix_(int_i, sep_i)] if len(sep_i) else np.zeros((len(int_i), 3))
            F = M[np.ix_(int_i, sep_r)] if len(sep_r) else np.zeros((len(int_i), 3))
            YC = Aii_inv @ np.hstack([E, F])  # [I, 6]

            Ti = T[owned, :]  # [owned, K]
            Tsep = Ti[:, sep_i] if len(sep_i) else np.zeros((len(owned), 3))
            Tnext = Ti[:, sep_r] if len(sep_r) else np.zeros((len(owned), 3))
            Tint = Ti[:, int_i]
            ap = Tint @ Y[: len(int_i)]  # [owned, W]
            ac = np.hstack([Tsep, Tnext]) - Tint @ YC  # [owned, 6]
            AP[i, v] = _pad(ap, W, W)
            AC[i, v] = _pad(ac, W, 6)

    return SchurOps(n=n, cl=cl, W=W, GL=GL, GRr=GRr, CS=CS, AP=AP, AC=AC)


# ---------------------------------------------------------------------------
# Parallel cyclic reduction (PCR) of the block-tridiagonal interface system:
# replaces the 3-rows-per-shard all_gather + dense [6, 3n] interface matvec
# with O(log n) ppermutes of 3-row slabs — per-chip interface communication
# and memory drop from O(n) to O(log n), the shape needed past O(100) cuts.


@dataclass(frozen=True)
class PCROps:
    """Per-level PCR elimination matrices (numpy float64).

    Level k (distance ``dists[k]``, the recurrence d_0 = 1,
    d_{k+1} = 2 d_k mod n) updates each shard's interface RHS block as
    ``y_i += A[k,i] @ y_{(i-d) % n} + B[k,i] @ y_{(i+d) % n}``; after all
    levels the system is block-diagonal and ``c_i = Dinv[i] @ y_i``.
    """

    n: int
    levels: int
    dists: tuple  # [levels] ppermute distances
    A: np.ndarray  # [levels, n, v, 3, 3]
    B: np.ndarray  # [levels, n, v, 3, 3]
    Dinv: np.ndarray  # [n, v, 3, 3]


def build_pcr_ops(
    params: GridParameters,
    n: int,
    tol: float = 1e-28,
    ifaces: list | None = None,
) -> PCROps:
    """Precompute PCR elimination matrices for the [3n, 3n] interface system.

    The reduction is matrix-driven: each level eliminates the couplings at
    block distance d = 2**k using the actual reduced matrix, so any block
    structure reachable by the update rule is handled exactly.  For
    non-periodic grids (zero out-of-range blocks) and periodic grids with
    power-of-two ``n`` the reduction terminates exactly in ceil(log2 n)
    levels; for periodic non-power-of-two ``n`` couplings decay
    quadratically instead (diagonally dominant Gram Schur complement), so a
    few extra levels drive them below roundoff — the final block-diagonality
    is asserted against ``tol`` either way."""
    p = params
    cl = _check_partition(p, n)
    nv = p.nvars
    base = max(1, int(np.ceil(np.log2(n))))
    max_levels = base + 8

    if ifaces is None:
        ifaces = var_interfaces(p, n)
    per_var = []  # (A_levels, B_levels, Dinv[n,3,3])
    blk = lambda S, i, j: S[3 * i : 3 * i + 3, 3 * j : 3 * j + 3]
    for v in range(nv):
        S = ifaces[v][4]
        A_lvls, B_lvls = [], []
        d = 1
        for k in range(max_levels):
            offdiag = max(
                (np.abs(blk(S, i, j)).max() if i != j else 0.0)
                for i in range(n)
                for j in range(n)
                if np.any(blk(S, i, j))
            ) if n > 1 else 0.0
            diag = max(np.abs(blk(S, i, i)).max() for i in range(n))
            if offdiag <= np.sqrt(tol) * diag or d == 0:
                break
            Ak = np.zeros((n, 3, 3))
            Bk = np.zeros((n, 3, 3))
            Snew = np.zeros_like(S)
            for i in range(n):
                im, ip = (i - d) % n, (i + d) % n
                nz = lambda bb: np.abs(bb).max() > 1e-13 * diag
                support = {
                    j for j in range(n) if nz(blk(S, i, j)) and j != i
                }
                if not support <= {im, ip}:
                    raise ValueError(
                        f"PCR level {k}: row {i} couples blocks {support} "
                        f"outside {{{im},{ip}}} — unsupported partition"
                    )
                a = np.zeros((3, 3))
                b = np.zeros((3, 3))
                if im != i and nz(blk(S, i, im)):
                    a = -blk(S, i, im) @ np.linalg.inv(blk(S, im, im))
                if ip != i and ip != im and nz(blk(S, i, ip)):
                    b = -blk(S, i, ip) @ np.linalg.inv(blk(S, ip, ip))
                Ak[i], Bk[i] = a, b
                row = S[3 * i : 3 * i + 3, :].copy()
                row += a @ S[3 * im : 3 * im + 3, :]
                row += b @ S[3 * ip : 3 * ip + 3, :]
                Snew[3 * i : 3 * i + 3, :] = row
            # clip eliminated-block roundoff so support stays sparse
            for i in range(n):
                for j in range(n):
                    if i != j and np.abs(blk(Snew, i, j)).max() <= 1e-13 * diag:
                        Snew[3 * i : 3 * i + 3, 3 * j : 3 * j + 3] = 0.0
            S = Snew
            A_lvls.append(Ak)
            B_lvls.append(Bk)
            d = (2 * d) % n
        # assert block-diagonal to tolerance
        for i in range(n):
            for j in range(n):
                if i != j and np.abs(blk(S, i, j)).max() > np.sqrt(tol) * max(
                    1.0, np.abs(blk(S, i, i)).max()
                ):
                    raise ValueError(
                        f"PCR did not converge for var {v}: residual "
                        f"coupling ({i},{j}) = {np.abs(blk(S, i, j)).max():.2e}"
                    )
        Dinv = np.stack([np.linalg.inv(blk(S, i, i)) for i in range(n)])
        per_var.append((A_lvls, B_lvls, Dinv))

    levels = max(len(a) for a, _, _ in per_var)
    dists = []
    d = 1
    for _ in range(levels):
        dists.append(d)
        d = (2 * d) % n
    A = np.zeros((levels, n, nv, 3, 3))
    B = np.zeros((levels, n, nv, 3, 3))
    Dinv = np.zeros((n, nv, 3, 3))
    for v, (A_l, B_l, Dv) in enumerate(per_var):
        for k in range(len(A_l)):
            A[k, :, v] = A_l[k]
            B[k, :, v] = B_l[k]
        # vars that converged early: identity levels (A=B=0) are no-ops
        Dinv[:, v] = Dv
    return PCROps(n=n, levels=levels, dists=tuple(dists), A=A, B=B, Dinv=Dinv)


def numpy_pcr_interface(ops: PCROps, g: np.ndarray) -> np.ndarray:
    """Numpy emulation of the distributed PCR interface solve.

    ``g``: [n, v, 3, ...] per-shard interface RHS blocks (as produced by the
    GL/GRr stage).  Returns ``c6`` [n, v, 6, ...]: each shard's own cut
    solution stacked with its right neighbor's — exactly what the gather
    path's CS matvec yields."""
    n = ops.n
    y = g.copy()
    for k in range(ops.levels):
        d = ops.dists[k]
        y_prev = np.stack([y[(i - d) % n] for i in range(n)])
        y_next = np.stack([y[(i + d) % n] for i in range(n)])
        y = (
            y
            + np.einsum("ivab,ivb...->iva...", ops.A[k], y_prev)
            + np.einsum("ivab,ivb...->iva...", ops.B[k], y_next)
        )
    c = np.einsum("ivab,ivb...->iva...", ops.Dinv, y)
    c_next = np.stack([c[(i + 1) % n] for i in range(n)])
    return np.concatenate([c, c_next], axis=2)


def numpy_sharded_analysis(
    params: GridParameters,
    ops: SchurOps,
    phys: np.ndarray,
    pcr: PCROps | None = None,
) -> np.ndarray:
    """Sequential numpy emulation of the distributed analysis: shard the
    physical field, run projections + the 5-matrix Schur pipeline exactly as
    the shard_map path does (including the two ppermutes and the gather),
    and reassemble the canonical spectral array.  Ground truth for tests.

    ``pcr``: replace the gather + CS interface solve with the O(log n)
    parallel-cyclic-reduction emulation (``numpy_pcr_interface``)."""
    p = params
    n, cl, W = ops.n, ops.cl, ops.W
    nb = p.b_rDim
    nv = p.nvars
    mub = bspline.MUBAR
    trailing = phys.shape[2:]

    # per-shard local projection windows (nonzero rows of the local
    # quadrature projection in the shard's raw window)
    p_loc = np.zeros((n, nv, W) + trailing)
    for v in range(nv):
        bops = bspline.build_ops(p.xmin, p.xmax, p.num_cells, p.BCL[v], p.BCR[v], p.l_q)
        proj = bops.project  # [nb, rDim]
        for i in range(n):
            rows = slice(i * cl, i * cl + W)
            cols = slice(i * cl * mub, (i + 1) * cl * mub)
            p_loc[i, v] = np.einsum(
                "br,r...->b...", proj[rows, cols], phys[v, i * cl * mub : (i + 1) * cl * mub]
            )

    # right-going overflow ppermute (shard n-1 owns its tail, sends nothing)
    p_own = p_loc.copy()
    for i in range(n - 1):
        p_own[i + 1, :, 0:3] += p_loc[i, :, cl : cl + 3]
        p_own[i, :, cl : cl + 3] = 0.0

    # interface partials + right-going ppermute
    g = np.einsum("ivsw,ivw...->ivs...", ops.GL, p_own)
    gr = np.einsum("ivsw,ivw...->ivs...", ops.GRr, p_own)
    for i in range(n):
        g[(i + 1) % n] += gr[i]

    # interface solve: gather + CS matvec, or distributed PCR
    if pcr is not None:
        c6 = numpy_pcr_interface(pcr, g)
    else:
        g_all = np.moveaxis(g, 0, 1).reshape((nv, 3 * n) + trailing)  # [v, 3n, ...]
        c6 = np.einsum("ivsg,vg...->ivs...", ops.CS, g_all)

    # back-substitution to owned raw rows
    a_own = np.einsum("ivuw,ivw...->ivu...", ops.AP, p_own) + np.einsum(
        "ivus,ivs...->ivu...", ops.AC, c6
    )

    # reassemble canonical spectral array from owned rows
    spec = np.zeros((nv, nb) + trailing)
    for i in range(n):
        owned = W if i == n - 1 else cl
        spec[:, i * cl : i * cl + owned] = a_own[i, :, :owned]
    return spec
