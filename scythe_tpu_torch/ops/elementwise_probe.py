"""Fused elementwise probe of the MoistEulerRLZ tendency stage: a Triton
kernel for Hopper and its plain PyTorch version.

Replaces the Pallas TPU kernel ``tools/probe_pallas_elementwise.py``
(``pk``): one pass over seven slot tensors ``[V, R, LZ]`` (value and the six
derivative slots, with (l, z) flattened) and the radial factor ``rinv``
``[1, R, 1]``, computing

    u, v, w = val[3:4], val[4:5], val[5:6]
    adv     = -u dr - (v rinv) dl - w dz
    lap     = K (drr + dr rinv + dll rinv^2 + dzz)
    out     = adv + lap + exp(0.01 val) log1p(val^2)

It stands in for a fused tendency: advection, Laplacian and a transcendental
term, with no reduction.  What bounds it on the card is HBM: at the probe
shape ([9, 144, 3072] f32) a pass reads seven 16 MB tensors and writes one,
~127 MB, ~38 us at 3.35 TB/s; the plain version makes ~20 eager passes.
Design: one program per (radial row, block of BLOCK points of the row);
u, v, w and rinv are loaded once and reused for all V rows of the output,
so each input byte is read once.  ``log1p`` is computed as
log(1 + y) y / ((1 + y) - 1), accurate to a few ulps, so the kernel needs no
libdevice.

The wrapper ``probe_expr`` takes the plain version for tensors on the CPU
and launches the Triton kernel for tensors on a CUDA device; there is no
fallback between the two.  ``launches`` counts kernel launches only.
Triton is imported, and its cache pointed into ``scythe_tpu_torch/_build``,
only when the kernel is first launched.

    python -m scythe_tpu_torch.ops.elementwise_probe   # on a card: rel err, times
"""

from __future__ import annotations

import functools

import torch

K = 10.0  # the probe's diffusivity
SHAPE = (9, 144, 3072)  # [V, R, L x Z] of moist3d (64 x 48)
BLOCK = 1024

launches = 0


def probe_expr_plain(val, dr, drr, dl, dll, dz, dzz, rinv):
    """The probe's expression in plain PyTorch (the tool's ``expr``)."""
    u, v, w = val[3:4], val[4:5], val[5:6]
    adv = -u * dr - (v * rinv) * dl - w * dz
    lap = K * (drr + dr * rinv + dll * (rinv * rinv) + dzz)
    thermo = torch.exp(val * 0.01) * torch.log1p(val * val)
    return adv + lap + thermo


@functools.cache
def _kernel():
    """Import Triton and define the kernel (first launch only)."""
    global tl
    from ._build import triton_cache_dir

    triton_cache_dir()
    import triton
    import triton.language as tl

    @triton.jit
    def probe_kernel(val, dr, drr, dl, dll, dz, dzz, rinv, out, R, LZ, k_diff,
                     V: tl.constexpr, BLOCK: tl.constexpr):
        row = tl.program_id(0)
        offs = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
        m = offs < LZ
        ri = tl.load(rinv + row)
        plane = R * LZ
        base = row * LZ + offs
        u = tl.load(val + 3 * plane + base, mask=m, other=0.0)
        v = tl.load(val + 4 * plane + base, mask=m, other=0.0)
        w = tl.load(val + 5 * plane + base, mask=m, other=0.0)
        vri = v * ri
        for c in tl.static_range(V):
            o = c * plane + base
            x = tl.load(val + o, mask=m, other=0.0)
            d_r = tl.load(dr + o, mask=m, other=0.0)
            d_l = tl.load(dl + o, mask=m, other=0.0)
            d_z = tl.load(dz + o, mask=m, other=0.0)
            adv = -u * d_r - vri * d_l - w * d_z
            lap = k_diff * (tl.load(drr + o, mask=m, other=0.0) + d_r * ri
                            + tl.load(dll + o, mask=m, other=0.0) * (ri * ri)
                            + tl.load(dzz + o, mask=m, other=0.0))
            y = x * x
            y1 = 1.0 + y
            lg = tl.where(y1 == 1.0, y, tl.log(y1) * (y / (y1 - 1.0)))
            tl.store(out + o, adv + lap + tl.exp(x * 0.01) * lg, mask=m)

    return triton, probe_kernel


def _check(args):
    val, rinv = args[0], args[7]
    if val.ndim != 3 or val.shape[0] < 6:
        raise ValueError(f"val must be [V >= 6, R, LZ]; got {tuple(val.shape)}")
    V, R, LZ = val.shape
    if tuple(rinv.shape) != (1, R, 1):
        raise ValueError(f"rinv must be [1, {R}, 1]; got {tuple(rinv.shape)}")
    for t in args:
        if t.dtype != val.dtype or t.device != val.device:
            raise ValueError("the probe's tensors must share one dtype and device")
    for t in args[1:7]:
        if t.shape != val.shape:
            raise ValueError(f"every slot must be {tuple(val.shape)}; got {tuple(t.shape)}")
    return V, R, LZ


def _launch(args, V, R, LZ):
    global launches
    if args[0].dtype != torch.float32:
        raise ValueError(f"the probe kernel takes float32, got {args[0].dtype}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("the probe kernel needs contiguous tensors")
    triton, kernel = _kernel()
    out = torch.empty_like(args[0])
    with torch.cuda.device(args[0].device):
        kernel[(R, triton.cdiv(LZ, BLOCK))](
            *args, out, R, LZ, K, V=V, BLOCK=BLOCK, num_warps=8,
        )
    launches += 1
    return out


def probe_expr(val, dr, drr, dl, dll, dz, dzz, rinv):
    """The probe's expression over ``[V, R, LZ]`` slots and ``rinv``
    ``[1, R, 1]``: the Triton kernel on a CUDA device, the plain version on
    the CPU."""
    args = (val, dr, drr, dl, dll, dz, dzz, rinv)
    V, R, LZ = _check(args)
    if val.device.type == "cpu":
        return probe_expr_plain(*args)
    if val.device.type != "cuda":
        raise ValueError(f"probe_expr runs on cpu or cuda tensors, got {val.device}")
    return _launch(args, V, R, LZ)


def probe_inputs(device, shape=SHAPE, seed=0, dtype=torch.float32):
    """The probe's inputs as the tool makes them: seven normal slot tensors
    from ``seed`` (numpy) and rinv = 1/r over r in [100, 20000] m."""
    import numpy as np

    V, R, LZ = shape
    rng = np.random.default_rng(seed)
    slots = [
        torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device, dtype)
        for _ in range(7)
    ]
    rinv = (1.0 / np.linspace(100.0, 20000.0, R)).astype(np.float32)
    return (*slots, torch.from_numpy(rinv)[None, :, None].to(device, dtype))


def main() -> int:
    import sys

    if not torch.cuda.is_available():
        print("the probe needs a CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    args = probe_inputs("cuda")
    ref = probe_expr_plain(*args)
    got = probe_expr(*args)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max() / ref.abs().max())
    print("rel err:", err)

    def time_ms(fn, n=50):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fn()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    plain = [time_ms(lambda: probe_expr_plain(*args))]
    kern = [time_ms(lambda: probe_expr(*args)) for _ in range(2)]
    plain.append(time_ms(lambda: probe_expr_plain(*args)))
    print(f"{torch.cuda.get_device_name(0)}, {list(SHAPE)} f32")
    print(f"plain PyTorch expr: {min(plain) * 1e3:8.1f} us ({plain})")
    print(f"Triton kernel:      {min(kern) * 1e3:8.1f} us ({kern})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
