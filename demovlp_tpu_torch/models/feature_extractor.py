"""Region features from raw frames (counterpart of
demovlp_tpu/models/feature_extractor.py, `PatchRegionExtractor`).

The reference reads offline bottom-up-attention features that an external
detector wrote. This module computes regions from pixels instead: a ViT
encodes each frame, a learned query scores its patches, and the top-K
patches become the frame's regions, in the offline pipeline's contract
(data/regions.py): `object` (B, F, K, 2048 + 6) appearance and geometry,
`object_mask` (B, F, K), `conf` (B, F, K), sorted by confidence. So
ObjectRelation and the QA / MC models run from pixels unchanged, and
gradients reach the extractor.

  * Patches are the proposals: a (H/p) x (W/p) grid, row-major, static
    shapes. Geometry is the patch box in the reference's normalised 6-d
    layout (x1/W, y1/H, x2/W, y2/H, w/W, h/H).
  * Confidence is the saliency softmax mass. Equal confidences keep the
    lower patch index first (a stable descending sort), as jax.lax.top_k
    orders them; torch.topk does not.
  * The layers follow flax's: a patchify convolution (flax's HWIO kernel is
    the torch (D, 3, p, p) weight), LayerNorms (eps 1e-6) in f32 with the
    result cast back to the compute dtype inside the blocks, attention as
    flax's MultiHeadDotProductAttention computes it (q, k, v projections
    into (H, hd), the query scaled by 1/sqrt(hd) before the product, a
    softmax, the output projection from (H, hd)), exact GELU; the final
    norm, the saliency product and the outputs stay f32.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from demovlp_tpu_torch.models.layers import (Dense, LayerNormFp32, Mlp, init_weights,
                                             trunc_normal_)

APPEARANCE_DIM = 2048
GEOMETRY_DIM = 6


class _SelfAttention(nn.Module):
    """flax MultiHeadDotProductAttention over one sequence, in the compute
    dtype. Each projection is a Dense over the flattened (H, hd) axis."""

    def __init__(self, dim: int, heads: int, compute_dtype: torch.dtype):
        super().__init__()
        if dim % heads:
            raise ValueError(f"embed_dim {dim} is not a multiple of heads {heads}")
        self.heads = heads
        self.query = Dense(dim, dim, compute_dtype=compute_dtype)
        self.key = Dense(dim, dim, compute_dtype=compute_dtype)
        self.value = Dense(dim, dim, compute_dtype=compute_dtype)
        self.out = Dense(dim, dim, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, length, d = x.shape
        h, hd = self.heads, d // self.heads
        q = self.query(x).view(n, length, h, hd)
        k = self.key(x).view(n, length, h, hd)
        v = self.value(x).view(n, length, h, hd)
        # flax: query / sqrt(depth), the divisor rounded to the compute dtype
        q = q / torch.tensor(math.sqrt(hd), dtype=torch.float32).to(q.dtype)
        w = torch.softmax(torch.einsum("nqhd,nkhd->nhqk", q, k), dim=-1)
        ctx = torch.einsum("nhqk,nkhd->nqhd", w, v)
        return self.out(ctx.reshape(n, length, d))


class _ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, compute_dtype: torch.dtype):
        super().__init__()
        self.norm1 = LayerNormFp32(dim)
        self.attn = _SelfAttention(dim, heads, compute_dtype)
        self.norm2 = LayerNormFp32(dim)
        self.mlp = Mlp(dim, 4 * dim, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchRegionExtractor(nn.Module):
    """Raw frames -> bottom-up-attention-compatible region features.

    Input: frames (B, F, H, W, 3) float in [0, 1], H x W = `image_size`
    (the JAX module infers its position table from its first input; here
    the table is sized by `image_size`). Output: dict(object (B, F, K,
    2054) f32, object_mask (B, F, K) ones, conf (B, F, K) f32)."""

    def __init__(self, object_num: int = 30, patch: int = 16, embed_dim: int = 384,
                 depth: int = 6, heads: int = 6, image_size=224,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        h, w = (image_size, image_size) if isinstance(image_size, int) else image_size
        if h % patch or w % patch:
            raise ValueError(f"image size {(h, w)} is not a multiple of patch {patch}")
        self.object_num, self.patch, self.embed_dim = object_num, patch, embed_dim
        self.image_size = (h, w)
        self.grid = (h // patch, w // patch)
        n = self.grid[0] * self.grid[1]
        if object_num > n:
            raise ValueError(f"object_num {object_num} exceeds the {n} patches of a frame")
        self.compute_dtype = compute_dtype
        self.stem = nn.Conv2d(3, embed_dim, patch, stride=patch)
        self.pos_embed = nn.Parameter(torch.zeros(1, n, embed_dim))
        for i in range(depth):
            self.add_module(f"block_{i}", _ViTBlock(embed_dim, heads, compute_dtype))
        self.depth = depth
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
        self.saliency_query = nn.Parameter(torch.zeros(embed_dim))
        self.appearance_proj = Dense(embed_dim, APPEARANCE_DIM, compute_dtype=compute_dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisers: lecun-normal kernels (the stem's fan-in is
        3 p^2), zero biases, unit LayerNorms, truncated normal 0.02 for
        `pos_embed` and `saliency_query`."""
        init_weights(self, generator)
        fan_in = 3 * self.patch * self.patch
        trunc_normal_(self.stem.weight, 1.0 / math.sqrt(fan_in) / 0.87962566, generator)
        with torch.no_grad():
            self.stem.bias.zero_()
        trunc_normal_(self.pos_embed, 0.02, generator)
        trunc_normal_(self.saliency_query, 0.02, generator)

    def forward(self, frames: torch.Tensor):
        b, f, h, w, c = frames.shape
        if (h, w) != self.image_size:
            raise ValueError(f"frames of {(h, w)}; this extractor takes {self.image_size}")
        gh, gw = self.grid
        k, d, cd = self.object_num, self.embed_dim, self.compute_dtype

        x = frames.reshape(b * f, h, w, c).permute(0, 3, 1, 2).to(cd)
        x = F.conv2d(x, self.stem.weight.to(cd), self.stem.bias.to(cd), stride=self.patch)
        x = x.flatten(2).transpose(1, 2)  # (BF, n, D), patches row-major over (gh, gw)
        x = x + self.pos_embed.to(cd)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
        x = F.layer_norm(x.float(), (d,), self.norm.weight, self.norm.bias, self.norm.eps)

        logits = torch.einsum("npd,d->np", x, self.saliency_query)
        conf_all = torch.softmax(logits * (d ** -0.5), dim=-1)
        conf, idx = torch.sort(conf_all, dim=-1, descending=True, stable=True)
        conf, idx = conf[:, :k], idx[:, :k]

        sel = torch.gather(x, 1, idx[..., None].expand(-1, -1, d))  # (BF, K, D)
        appearance = self.appearance_proj(sel.to(cd)).float()

        gy = torch.div(idx, gw, rounding_mode="floor").float()
        gx = (idx % gw).float()
        geometry = torch.stack([gx / gw, gy / gh, (gx + 1.0) / gw, (gy + 1.0) / gh,
                                torch.full_like(gx, 1.0 / gw), torch.full_like(gy, 1.0 / gh)],
                               dim=-1)
        obj = torch.cat([appearance, geometry], dim=-1)
        return {
            "object": obj.reshape(b, f, k, APPEARANCE_DIM + GEOMETRY_DIM),
            "object_mask": torch.ones((b, f, k), dtype=torch.float32, device=frames.device),
            "conf": conf.reshape(b, f, k),
        }
