"""The frozen FLOP model of a Frozen in Time training step, as counts/
flops.py models a region step: a product is 2 per multiply-add; norms,
softmax and elementwise work omitted; the backward is 2 x the forward.

Video tower on one clip of F frames of N patches (T = 1 + F N tokens):
  * patch embedding: F N patches of 3 P^2 values to D, 2 F N 3 P^2 D;
  * each block: time and space attention's q, k, v and out projections
    2 x 4 T D^2 x 2, the MLP 2 T D (4 D) x 2;
  * time attention's products: each of the F N queries over its group's F
    keys and CLS (q k and p v), 4 F N (F + 1) D, and the CLS query over
    all T keys, 4 T D; space attention the same with groups of N patches,
    4 F N (N + 1) D + 4 T D;
  * vid_proj on the CLS row, 2 D proj.
Text tower: counts/flops.tower_flops over the caption's length, and
txt_proj on the CLS row, 2 D proj. The step adds the global sims,
2 B^2 proj, forward and backward.
"""
from __future__ import annotations

from benchmark.counts.flops import tower_flops


def video_forward(frames: int, patches: int, patch: int = 16, dim: int = 768, depth: int = 12,
                  proj: int = 256, channels: int = 3) -> float:
    f, n, d = frames, patches, dim
    t = 1 + f * n
    linears = 2 * 4 * t * d * d * 2 + 2 * t * d * 4 * d * 2
    time = 4 * f * n * (f + 1) * d + 4 * t * d
    space = 4 * f * n * (n + 1) * d + 4 * t * d
    embed = 2 * f * n * channels * patch * patch * d
    return float(embed + depth * (linears + time + space) + 2 * d * proj)


def text_forward(text_len: int, text_dim: int = 768, text_layers: int = 6,
                 proj: int = 256) -> float:
    return tower_flops(text_len, text_dim, 4 * text_dim, text_layers) + 2.0 * text_dim * proj


def step(batch: int, frames: int, patches: int, text_len: int, patch: int = 16,
         dim: int = 768, depth: int = 12, text_dim: int = 768, text_layers: int = 6,
         proj: int = 256) -> float:
    """FLOP of one training step over `batch` pairs: both towers forward and
    backward and the global sims."""
    towers = 3.0 * batch * (video_forward(frames, patches, patch, dim, depth, proj)
                            + text_forward(text_len, text_dim, text_layers, proj))
    return towers + 3.0 * 2 * batch * batch * proj
