"""Mask conventions and the shared l2norm (counterpart of
demovlp_tpu/ops/masking.py).

A binary mask (1 = valid, 0 = pad) maps to the additive bias
(mask - 1) * 100: 0 for valid, -100 for padded positions. -100 (not -inf)
is the reference's "soft" masking constant and is kept for parity.
"""
from __future__ import annotations

import torch

MASK_SCALE = 100.0


def additive_mask(binary_mask: torch.Tensor, scale: float = MASK_SCALE) -> torch.Tensor:
    """(1, 0) validity mask -> (0, -scale) additive f32 attention bias."""
    return (binary_mask.to(torch.float32) - 1.0) * scale


def l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    """x / (sqrt(sum(x^2)) + eps): eps is ADDED to the norm, not a floor."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True)) + eps
    return x / norm
