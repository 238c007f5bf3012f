"""Global cosine-similarity matrix (counterpart of
demovlp_tpu/ops/similarity.py)."""
from __future__ import annotations

import torch


def sim_matrix(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Pairwise cosine <a_i, b_j> / (|a_i| |b_j|), each norm floored at eps."""
    a_n = torch.clamp(torch.linalg.norm(a, dim=1, keepdim=True), min=eps)
    b_n = torch.clamp(torch.linalg.norm(b, dim=1, keepdim=True), min=eps)
    return (a / a_n) @ (b / b_n).T


def cosine_similarity(
    x1: torch.Tensor, x2: torch.Tensor, dim: int = -1, eps: float = 1e-8
) -> torch.Tensor:
    """cos(x1, x2) along `dim` with the product of norms clamped at eps."""
    w12 = torch.sum(x1 * x2, dim=dim)
    w1 = torch.linalg.norm(x1, dim=dim)
    w2 = torch.linalg.norm(x2, dim=dim)
    return w12 / torch.clamp(w1 * w2, min=eps)
