"""The numpy half (``split_radix``, ``FactoredDFT``, ``analysis_np``,
``synthesis_np``) is copied verbatim from ``scythe_tpu.basis.fourier_factored``
(numpy only, so the port can import it without jax);
tests/test_torch_factored_dft.py pins every operator array-equal to the
original.  ``FactOps``, ``analysis_mm`` and ``synthesis_mm`` are their torch
counterparts: they apply the stages through the grid's ``_mm``, so the
compensated bf16x3 mode covers them too.

Radix-split (factored) azimuthal real DFT — FFT-free, still GEMMs.

The dense [nl, nl] real-DFT matmul (fourier.py) costs O(nl) flops per
point and O(nl^2) operator memory.  This module factors the transform
Cooley-Tukey style into two much smaller GEMM stages plus an elementwise
twiddle, cutting the azimuthal flops to O(n1+n2) per point while keeping
everything on the MXU (no FFT primitive — unavailable on some TPU
runtimes — and no dynamic shapes).  Measured on v5e the transform is
HBM-bandwidth bound, so the flop savings are only marginal at moderate
nl (docs/RESULTS.md round-2 table); the mode auto-enables for nl > 2048,
where the dense operator constants themselves become impractical
(create_grid auto policy).

Math (decimation in frequency, nl = n1 * n2, both even):
    k = k2 + n2*k1,   l = l1 + n1*l2
    c[k1,k2] = sum_l1 e^{-2pi i k1 l1/n1} ( e^{-2pi i k2 l1/nl}
               sum_l2 x[l1 + n1 l2] e^{-2pi i k2 l2/n2} ) / nl

DIF is chosen because the conjugate-symmetric half k <= nl/2 is then the
contiguous block k1 <= n1/2 — no gather/permute is needed anywhere.

Spectral layout (replaces the dense [mean, cos.., sin..] layout on
factored grids): planes-major flattened [2, n1/2+1, n2] -> K_f slots,
with invalid slots (Im at k=0 and k=nl/2; the k1=n1/2 row beyond k2=0)
permanently zeroed by ``base_mask``.  Complex arithmetic is carried as a
leading length-2 plane axis; each complex GEMM is one real einsum with
the planes folded into the contraction.

Derivative synthesis multiplies coefficients by (i k) / (-k^2)
elementwise before the shared synthesis stages; the Nyquist first
derivative is zeroed to match the dense path's collocation convention.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import fourier


def split_radix(nl: int) -> tuple[int, int]:
    """Pick n1 * n2 = nl with both even and as square as possible."""
    best = None
    for n1 in range(2, int(np.sqrt(nl)) + 1):
        if nl % n1 == 0 and n1 % 2 == 0 and (nl // n1) % 2 == 0:
            best = n1
    if best is None:
        raise ValueError(f"nl={nl} has no even x even factorization")
    return best, nl // best


@lru_cache(maxsize=None)
class FactoredDFT:
    """Precomputed numpy operator set for one nl (hashable, cached)."""

    def __init__(self, nl: int):
        n1, n2 = split_radix(nl)
        self.nl, self.n1, self.n2 = nl, n1, n2
        self.n1h = n1 // 2 + 1
        self.K = 2 * self.n1h * n2  # spectral slots incl. masked-invalid

        l1 = np.arange(n1)
        l2 = np.arange(n2)
        k1 = np.arange(self.n1h)
        k2 = np.arange(n2)

        # --- analysis stages -------------------------------------------
        # stage 1 (contract l2): planes of e^{-2pi i k2 l2/n2} / nl
        ang = 2 * np.pi * np.outer(k2, l2) / n2
        self.W2a = np.stack([np.cos(ang), -np.sin(ang)]) / nl  # [2, n2, n2]
        # twiddle e^{-2pi i k2 l1 / nl}: planes [2, n2, n1]
        angt = 2 * np.pi * np.outer(k2, l1) / nl
        self.Ta = np.stack([np.cos(angt), -np.sin(angt)])
        # stage 2 (contract p, l1): complex GEMM planes [2, n1h, 2, n1]
        ang1 = 2 * np.pi * np.outer(k1, l1) / n1
        c1, s1 = np.cos(ang1), np.sin(ang1)
        W1a = np.zeros((2, self.n1h, 2, n1))
        W1a[0, :, 0, :] = c1
        W1a[0, :, 1, :] = s1  # Re: Wr*Yr - Wi*Yi with Wi = -sin
        W1a[1, :, 0, :] = -s1
        W1a[1, :, 1, :] = c1
        self.W1a = W1a

        # --- wavenumber map + masks ------------------------------------
        kmap = k2[None, :] + n2 * k1[:, None]  # [n1h, n2]
        valid = kmap <= nl // 2
        self.kmap = np.where(valid, kmap, 0)
        base = np.broadcast_to(valid, (2, self.n1h, n2)).copy()
        base[1][kmap == 0] = False  # Im(c_0) = 0
        base[1][kmap == nl // 2] = False  # Im(c_Nyquist) = 0
        self.base_mask = base.astype(np.float64).reshape(self.K)
        self.k_of_slot = np.broadcast_to(self.kmap, (2, self.n1h, n2)).reshape(
            self.K
        ) * (self.base_mask > 0)

        # synthesis coefficient weights: w=1 at k=0 and Nyquist, else 2
        w = np.where((self.kmap == 0) | (self.kmap == nl // 2), 1.0, 2.0)
        self.w_synth = (
            np.broadcast_to(w, (2, self.n1h, n2)).reshape(self.K) * self.base_mask
        )
        # derivative scales on (Re, Im) planes: i k -> (-k Im, +k Re)
        kk = self.kmap.astype(np.float64)
        kd = np.where(self.kmap == nl // 2, 0.0, kk)  # Nyquist d/dl -> 0
        self.k_d = np.stack([kd, kd]).reshape(self.K) * self.base_mask
        self.k_d2 = -np.stack([kk**2, kk**2]).reshape(self.K) * self.base_mask

        # --- synthesis stages ------------------------------------------
        # stage A (contract q, k1): u[p,l1,k2] = sum e^{+2pi i k1 l1/n1} c
        W1s = np.zeros((2, n1, 2, self.n1h))
        W1s[0, :, 0, :] = c1.T
        W1s[0, :, 1, :] = -s1.T  # Re: Wr*Cr - Wi*Ci with Wi = +sin
        W1s[1, :, 0, :] = s1.T
        W1s[1, :, 1, :] = c1.T
        self.W1s = W1s
        # twiddle e^{+2pi i k2 l1/nl}
        self.Ts = np.stack([np.cos(angt), np.sin(angt)])  # [2, n2, n1]
        # stage B (contract p, k2) with Re() folded in: [n2, 2, n2]
        W2s = np.zeros((n2, 2, n2))
        W2s[:, 0, :] = np.cos(ang).T
        W2s[:, 1, :] = -np.sin(ang).T  # Re: Wr*ur - Wi*ui with Wi = +sin
        self.W2s = W2s

    def ring_mask(self, r, dr, l_q: float = 2.0) -> np.ndarray:
        """[nr, K] mask combining conjugate-symmetry validity with the
        per-ring dealiasing cutoff (same kmax rule as the dense path)."""
        kmax = fourier.ring_kmax(np.asarray(r), dr, self.nl, l_q)
        keep = self.k_of_slot[None, :] <= kmax[:, None]
        return keep * self.base_mask[None, :]


def analysis_np(fd: FactoredDFT, x: np.ndarray) -> np.ndarray:
    """Reference numpy implementation: [..., nl] -> [..., K]."""
    sh = x.shape[:-1]
    X = x.reshape(sh + (fd.n2, fd.n1))  # [l2, l1]
    Y = np.einsum("pkl,...lm->...pkm", fd.W2a, X)  # [p, k2, l1]
    # complex twiddle (Ta planes: [cos, -sin] of the NEGATIVE exponent)
    yr = Y[..., 0, :, :] * fd.Ta[0] - Y[..., 1, :, :] * fd.Ta[1]
    yi = Y[..., 0, :, :] * fd.Ta[1] + Y[..., 1, :, :] * fd.Ta[0]
    Yt = np.stack([yr, yi], axis=-3)
    C = np.einsum("qkpl,...pjl->...qkj", fd.W1a, Yt)  # [q, k1, k2]
    return (C.reshape(sh + (fd.K,))) * fd.base_mask


def synthesis_np(fd: FactoredDFT, c: np.ndarray, deriv: int = 0) -> np.ndarray:
    """Reference numpy implementation: [..., K] -> [..., nl]."""
    sh = c.shape[:-1]
    scale = {0: fd.w_synth, 1: fd.w_synth * fd.k_d, 2: fd.w_synth * fd.k_d2}[deriv]
    cc = (c * scale).reshape(sh + (2, fd.n1h, fd.n2))
    if deriv == 1:  # multiply by i: (Re, Im) -> (-Im, Re)
        cc = np.stack([-cc[..., 1, :, :], cc[..., 0, :, :]], axis=-3)
    U = np.einsum("plqk,...qkj->...plj", fd.W1s, cc)  # [p, l1, k2]
    ur = U[..., 0, :, :] * fd.Ts[0].T - U[..., 1, :, :] * fd.Ts[1].T
    ui = U[..., 0, :, :] * fd.Ts[1].T + U[..., 1, :, :] * fd.Ts[0].T
    Ut = np.stack([ur, ui], axis=-3)  # [p, l1, k2]
    # emit [l2, l1] so the flatten yields l = l1 + n1*l2 (l1 fastest)
    X = np.einsum("mpk,...plk->...ml", fd.W2s, Ut)
    return X.reshape(sh + (fd.nl,))


# ---------------------------------------------------------------------------
# Application through a Grid._mm-style callable (so the compensated bf16x3
# mode covers the factored stages too).  The twiddle and coefficient scalings
# are elementwise in the grid's dtype and bypass mm.


class FactOps:
    """The factored operators of one grid, as tensors on its device.

    ``prep`` makes an operator of a GEMM stage (the grid's own: plain, or
    the compensated [O_hi, O_lo, O_hi] stack); ``tensor`` an elementwise
    factor in the grid's dtype.  ``deriv_scale`` converts the
    integer-wavenumber derivatives d/dl to a physical coordinate: 2 pi / Ly
    on the XYZ y axis (as the dense path's ``deriv_scale``); 1 on angular
    axes."""

    def __init__(self, fd: FactoredDFT, prep, tensor, deriv_scale=1.0):
        self.fd = fd
        self.W2a = prep(fd.W2a)
        self.W1a = prep(fd.W1a)
        self.W1s = prep(fd.W1s)
        self.W2s = prep(fd.W2s)
        self.Ta = tensor(fd.Ta)
        self.Ts = tensor(fd.Ts)
        self.TsT = tensor(np.ascontiguousarray(np.swapaxes(fd.Ts, 1, 2)))
        self.w_synth = tensor(fd.w_synth)
        self.k_d = tensor(fd.w_synth * fd.k_d * deriv_scale)
        self.k_d2 = tensor(fd.w_synth * fd.k_d2 * deriv_scale**2)


def analysis_mm(fo: FactOps, mm, phys, with_z: bool):
    """[v, r, nl(, z)] -> unmasked spectral [v, r, K(, z)]."""
    fd = fo.fd
    sh = tuple(phys.shape)
    if with_z:
        X = phys.reshape(sh[:2] + (fd.n2, fd.n1) + sh[3:])
        Y = mm("ckl,vrlmz->vrckmz", fo.W2a, X)
        t0, t1 = fo.Ta[0][..., None], fo.Ta[1][..., None]
        yr = Y[:, :, 0] * t0 - Y[:, :, 1] * t1
        yi = Y[:, :, 0] * t1 + Y[:, :, 1] * t0
        Yt = torch.stack([yr, yi], dim=2)
        C = mm("qkcl,vrcjlz->vrqkjz", fo.W1a, Yt)
        return C.reshape(sh[:2] + (fd.K,) + sh[3:])
    X = phys.reshape(sh[:2] + (fd.n2, fd.n1))
    Y = mm("ckl,vrlm->vrckm", fo.W2a, X)
    yr = Y[:, :, 0] * fo.Ta[0] - Y[:, :, 1] * fo.Ta[1]
    yi = Y[:, :, 0] * fo.Ta[1] + Y[:, :, 1] * fo.Ta[0]
    Yt = torch.stack([yr, yi], dim=2)
    C = mm("qkcl,vrcjl->vrqkj", fo.W1a, Yt)
    return C.reshape(sh[:2] + (fd.K,))


def _scaled_slots(fo: FactOps, spec, derivs):
    """Stack deriv-scaled coefficient sets along a new axis 1:
    spec [v, b, K(, z)] -> [v, d, b, 2, n1h, n2(, z)]."""
    fd = fo.fd
    sh = tuple(spec.shape)
    trail = sh[3:]
    planes = (2, fd.n1h, fd.n2)
    ones = tuple(1 for _ in trail)

    def resh(x):
        return x.reshape(sh[:2] + planes + trail)

    out = []
    for d in derivs:
        if d == 0:
            out.append(resh(spec * fo.w_synth.reshape((fd.K,) + ones)))
        elif d == 1:
            cc = resh(spec * fo.k_d.reshape((fd.K,) + ones))
            # multiply by i: (Re, Im) -> (-Im, Re)
            out.append(torch.stack([-cc[:, :, 1], cc[:, :, 0]], dim=2))
        else:
            out.append(resh(spec * fo.k_d2.reshape((fd.K,) + ones)))
    return torch.stack(out, dim=1)  # [v, d, b, 2, n1h, n2(, z)]


def synthesis_mm(fo: FactOps, mm, spec, derivs, with_z: bool):
    """spec [v, b, K(, z)] -> [v, d, b, nl(, z)] for the requested
    derivative slots (0=value, 1=d/dl, 2=d2/dl2)."""
    fd = fo.fd
    cc = _scaled_slots(fo, spec, derivs)
    if with_z:
        U = mm("clqk,vdbqkjz->vdbcljz", fo.W1s, cc)
        t0 = fo.TsT[0][..., None]
        t1 = fo.TsT[1][..., None]
        ur = U[:, :, :, 0] * t0 - U[:, :, :, 1] * t1
        ui = U[:, :, :, 0] * t1 + U[:, :, :, 1] * t0
        Ut = torch.stack([ur, ui], dim=3)
        X = mm("mck,vdbclkz->vdbmlz", fo.W2s, Ut)
        sh = tuple(X.shape)
        return X.reshape(sh[:3] + (fd.nl,) + sh[5:])
    U = mm("clqk,vdbqkj->vdbclj", fo.W1s, cc)
    ur = U[:, :, :, 0] * fo.TsT[0] - U[:, :, :, 1] * fo.TsT[1]
    ui = U[:, :, :, 0] * fo.TsT[1] + U[:, :, :, 1] * fo.TsT[0]
    Ut = torch.stack([ur, ui], dim=3)
    X = mm("mck,vdbclk->vdbml", fo.W2s, Ut)
    sh = tuple(X.shape)
    return X.reshape(sh[:3] + (fd.nl,))
