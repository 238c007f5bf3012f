"""Operand rounding for the reference and its controls.

A control is the reference computed one step below the precision that the
configuration states, the step a later change might be tempted to take:
float8 (e4m3, one scale per tensor from its largest magnitude, as an fp8
matmul path scales) below bfloat16, TF32 (10-bit mantissa, products
accumulated in float32) below float32. Each function rounds a product's
operand and returns it in float32.
"""
from __future__ import annotations

from typing import Callable

import torch

Op = Callable[[torch.Tensor], torch.Tensor]
_E4M3_MAX = 448.0


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10-bit mantissa, nearest even, held in float32."""
    x = x.float().contiguous()
    bits = x.view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x scaled so its largest magnitude is e4m3's 448, rounded to e4m3 and
    scaled back, in float32."""
    x = x.float()
    amax = torch.clamp(x.detach().abs().max(), min=1e-30)
    scale = _E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


#: the step below each stated precision
BELOW = {"float32": tf32, "bfloat16": fp8}
#: the rounding of each stated precision itself
AT = {"float32": exact, "bfloat16": bf16}


def straight_through(fn: Op) -> Op:
    """`fn` in the forward, identity in the backward (gradients flow as
    through the rounding of a lower-precision product's operands)."""

    def op(x: torch.Tensor) -> torch.Tensor:
        return x + (fn(x) - x).detach()

    return op
