"""The bf16x3 arithmetic of the compensated mode, shared by the grid's
``_mm`` and the plain versions of the two compensated kernels.

The JAX package's compensated mode (``scythe_tpu.grids.base``) splits every
operand v into bf16 parts hi = bf16(v) and lo = bf16(v - hi), each rounded
to nearest even, and forms a product as hi·hi + lo·hi + hi·lo with f32
accumulation (the lo·lo term is dropped).  Here the bf16 values are held in
the caller's dtype: a product of two bf16 values is exact in float32, so
float32 arithmetic on them is the function the TPU's bf16 x bf16 -> f32
matrix unit computes (a bfloat16-output product would round the result to
bf16: another function).
"""

from __future__ import annotations

import torch


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (nearest even), kept in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def split_act(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The (hi, lo) bf16 split of an activation, both in x's dtype."""
    hi = bf16_round(x)
    return hi, bf16_round(x - hi)


def split_op(op: torch.Tensor) -> torch.Tensor:
    """The [O_hi, O_lo, O_hi] stack of an operator, in op's dtype (float32
    first: the JAX package splits the float32 operator)."""
    o32 = op.to(torch.float32)
    hi = bf16_round(o32)
    lo = bf16_round(o32 - hi)
    return torch.stack([hi, lo, hi]).to(op.dtype)


def comp_einsum(subs: str, op3: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The compensated product of an operator stack op3 = [O_hi, O_lo, O_hi]
    with x: one einsum contracting the stack axis against [x_hi, x_hi,
    x_lo], so O_hi x_hi + O_lo x_hi + O_hi x_lo."""
    xh, xl = split_act(x)
    a, rest = subs.split(",", 1)
    b, out = rest.split("->")
    return torch.einsum(f"p{a},p{b}->{out}", op3, torch.stack([xh, xh, xl]))
