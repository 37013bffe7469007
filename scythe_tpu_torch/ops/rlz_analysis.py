"""Fused RLZ spectral analysis: a hand-written CUDA kernel for Hopper and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``scythe_tpu/ops/pallas_transforms.py``
(``build_rlz_analysis``).  Physical ``[V, rDim, nl, nz]`` to spectral
``[V, b_rDim, nl, nz]`` in one pass, per variable v:

    a[r,k,z]     = ring_mask[r,k] * sum_l l_analysis[k,l] x[v,r,l,z]
    c[b,k,z]     = sum_r analysis_r[v,b,r] a[r,k,z]
    out[v,b,k,K] = sum_z analysis_z[v,K,z] c[b,k,z]

with the grid's own operators in its dtype (f32 or f64); the bf16 hi/lo
split of the TPU kernel is not ported.  The kernel (``csrc/rlz_analysis.cu``)
tiles the output by (k-tile, b-tile, variable) and keeps each tile's
accumulator in shared memory; its header says how the tiles are sized and
what bounds it.  The wrapper ``rlz_analysis`` checks its inputs, then takes
the plain version for tensors on the CPU and launches the kernel for
tensors on a CUDA device; there is no fallback between the two.
``launches`` counts kernel launches only.
"""

from __future__ import annotations

import ctypes

import torch

# the kernel's limits (rlz_analysis.cu): nz as the column solve's, nl as the
# dense DFT's (grids/base.py); a larger shape raises on CUDA
MAX_NZ = 128
MAX_NL = 2048

launches = 0


def rlz_analysis_plain(phys, l_analysis, ring_mask, analysis_r, analysis_z):
    """The chain in plain PyTorch: the einsums of ``Grid._analysis_with``
    (lambda DFT, ring mask, radial contraction, vertical analysis)."""
    hat = torch.einsum("kl,vrlz->vrkz", l_analysis, phys)
    hat = hat * ring_mask[None, :, :, None]
    rc = torch.einsum("vbr,vrkz->vbkz", analysis_r, hat)
    return torch.einsum("vKz,vbkz->vbkK", analysis_z, rc)


def _check(phys, ops) -> tuple[int, int, int, int, int]:
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
    B = ops[2].shape[1] if ops[2].ndim == 3 else 0  # analysis_r [V, b_rDim, rDim]
    want = {
        "l_analysis": (L, L),
        "ring_mask": (R, L),
        "analysis_r": (V, B, R),
        "analysis_z": (V, Z, Z),
    }
    for name, t in zip(names, ops):
        if tuple(t.shape) != want[name]:
            raise ValueError(
                f"{name} must be {list(want[name])} for phys "
                f"{list(phys.shape)}, got {list(t.shape)}"
            )
    return V, R, L, Z, B


def plan(phys_shape, b_rdim: int, dtype) -> dict:
    """The kernel's tiles at this shape (builds the library): KB azimuthal
    wavenumbers and BB radial coefficients a block, RC radial rows and LC
    azimuths a chunk, and the block's shared memory in bytes."""
    from ._build import load

    _, R, L, Z = phys_shape
    out = (ctypes.c_int * 5)()
    es = torch.empty((), dtype=dtype).element_size()
    load().lib.scythe_rlz_analysis_plan(R, L, Z, b_rdim, es, out)
    return dict(zip(("kb", "bb", "rc", "lc", "smem"), out))


def _launch(phys, ops, shape):
    global launches
    from ._build import load

    V, R, L, Z, B = shape
    if not 1 <= Z <= MAX_NZ or not 1 <= L <= MAX_NL:
        raise ValueError(
            f"the rlz_analysis kernel takes nz <= {MAX_NZ} and nl <= {MAX_NL}; "
            f"got nz = {Z}, nl = {L}"
        )
    for t in (phys,) + tuple(ops):
        if not t.is_contiguous():
            raise ValueError("the rlz_analysis kernel needs contiguous tensors")
    lib = load().lib
    fn = (
        lib.scythe_rlz_analysis_f32
        if phys.dtype == torch.float32
        else lib.scythe_rlz_analysis_f64
    )
    out = torch.empty((V, B, L, Z), dtype=phys.dtype, device=phys.device)
    with torch.cuda.device(phys.device):
        stream = torch.cuda.current_stream(phys.device).cuda_stream
        err = fn(
            phys.data_ptr(), *(o.data_ptr() for o in ops), out.data_ptr(),
            V, R, L, Z, B, stream,
        )
    if err != 0:
        msg = lib.scythe_cuda_error_string(err).decode()
        raise RuntimeError(f"rlz_analysis kernel launch failed: {msg} ({err})")
    launches += 1
    return out


def rlz_analysis(phys, l_analysis, ring_mask, analysis_r, analysis_z):
    """Physical ``[V, rDim, nl, nz]`` -> spectral ``[V, b_rDim, nl, nz]``
    with the RLZ grid's operators (``Grid.l_analysis``, ``ring_mask``,
    ``analysis_r``, ``analysis_z``)."""
    ops = (l_analysis, ring_mask, analysis_r, analysis_z)
    shape = _check(phys, ops)
    if phys.device.type == "cpu":
        return rlz_analysis_plain(phys, *ops)
    if phys.device.type != "cuda":
        raise ValueError(f"rlz_analysis runs on cpu or cuda tensors, got {phys.device}")
    return _launch(phys, ops, shape)
