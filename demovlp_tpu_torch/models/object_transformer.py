"""Region (object) tower with divided space-time attention (counterpart of
demovlp_tpu/models/object_transformer.py).

Reference quirks kept:
  * the (B, F, K, 2054) input splits into 2048-d appearance + 6-d geometry,
    embedded by two Linears and summed;
  * the position embedding goes on the CLS row only (custom_pos_embed[0]),
    plus per-frame temporal embeds repeated over each frame's K regions;
  * the space branch adds to the ORIGINAL x, not to the time residual;
  * there is no final norm (the reference's `norm` is never applied, so
    the port does not create it).

Attention stays a plain matmul with an f32 softmax, not SDPA: these
numerics are what the tests pin. `attn_impl` "dense" is masked full
attention with the `_block_bias` group mask; "xla" is the grouped form.
At one group (space at F=1, time at K=1) both take the plain path.

`remat` recomputes each block in the backward instead of keeping its
activations (torch.utils.checkpoint, non-reentrant, the RNG state kept so
any dropout recomputes identically): the same values and gradients, less
memory, one more forward of the blocks.

`norm_dtype` is each block's LayerNorm compute dtype (norm1, norm2 and,
with time attention, norm3, where JAX passes its `norm_dtype`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from demovlp_tpu_torch.models.layers import Dense, LayerNormFp32, Mlp
from demovlp_tpu_torch.ops.masking import additive_mask
from demovlp_tpu_torch.utils import profiling

APPEARANCE_DIM = 2048  # + 6-d box geometry = the 2054-d region feature
GEOMETRY_DIM = 6
MLP_RATIO = 4


def _block_bias(mode: str, frames: int, patches: int, device) -> torch.Tensor:
    """(1+F*K, 1+F*K) additive f32 bias: 0 where q is CLS, k is CLS, or both
    are in the same group (space: frame; time: region index), else -1e9."""
    n = frames * patches
    idx = torch.arange(n, device=device)
    g = idx // patches if mode == "space" else idx % patches
    allowed = torch.ones((1 + n, 1 + n), dtype=torch.bool, device=device)
    allowed[1:, 1:] = g[:, None] == g[None, :]
    return torch.where(allowed, 0.0, -1e9).to(torch.float32)


def _attention(q, k, v, bias):
    """softmax(q k^T + bias) v, head-FIRST layout (..., h, L, hd); f32
    logits and softmax, probabilities cast back to q's dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


class VarAttention(nn.Module):
    """Divided space/time attention with a globally attending CLS token."""

    def __init__(self, dim: int, num_heads: int, attn_impl: str = "dense",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if attn_impl not in ("xla", "dense"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}; expected 'xla' or 'dense'")
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.qkv = Dense(dim, 3 * dim, compute_dtype=compute_dtype)
        self.proj = Dense(dim, dim, compute_dtype=compute_dtype)

    def forward(self, x, add_mask, mode: str, frames: int, patches: int):
        b, n1, dim = x.shape
        f, k_ = frames, patches
        if n1 != 1 + f * k_:
            raise ValueError(f"token count {n1} != 1 + {f}*{k_}")
        hd = dim // self.num_heads
        qkv = self.qkv(x)
        # local head count: all heads, or this rank's share under the
        # tensor-parallel plan (parallel/tp.py), whose qkv rows are q, k, v
        # of this rank's heads
        dl = qkv.shape[-1] // 3
        h = dl // hd
        q, k, v = qkv.split(dl, dim=-1)
        # (B, N1, D) -> (B, h, N1, hd)
        q, k, v = (t.reshape(b, n1, h, hd).transpose(1, 2) for t in (q, k, v))
        q = q * torch.tensor(hd ** -0.5, dtype=torch.float32).to(q.dtype)
        mask = add_mask.float()  # (B, N1)

        single_group = (mode == "space" and f == 1) or (mode == "time" and k_ == 1)
        if single_group or self.attn_impl == "dense":
            bias = mask[:, None, None, :]
            if not single_group:
                bias = bias + _block_bias(mode, f, k_, x.device)
            out = _attention(q, k, v, bias)  # (B, h, N1, hd)
            return self.proj(out.transpose(1, 2).reshape(b, n1, dl))

        # grouped form: CLS attends over everything
        cls_out = _attention(q[:, :, :1], k, v, mask[:, None, None, :])  # (B,h,1,hd)
        m_ = mask[:, 1:].reshape(b, f, k_)
        if mode == "space":  # groups = frames, members = the K regions
            g = f

            def grp(t):  # (B, h, F*K, hd) -> (B, h, G, L, hd)
                return t.reshape(b, h, f, k_, hd)

            m_g = m_
        else:  # groups = region index, members = that region over F frames
            g = k_

            def grp(t):
                return t.reshape(b, h, f, k_, hd).transpose(2, 3)

            m_g = m_.transpose(1, 2)
        qg, kg, vg = grp(q[:, :, 1:]), grp(k[:, :, 1:]), grp(v[:, :, 1:])
        # CLS keys/values are visible to every group
        cls_k = k[:, :, None, :1].expand(b, h, g, 1, hd)
        cls_v = v[:, :, None, :1].expand(b, h, g, 1, hd)
        cls_m = mask[:, None, :1].expand(b, g, 1)
        kg = torch.cat([cls_k, kg], dim=3)
        vg = torch.cat([cls_v, vg], dim=3)
        mg = torch.cat([cls_m, m_g], dim=2)  # (B, G, 1+L)
        out = _attention(qg, kg, vg, mg[:, None, :, None, :])  # (B,h,G,L,hd)
        if mode == "time":
            out = out.transpose(2, 3)  # (B, h, F, K, hd)
        out = out.reshape(b, h, f * k_, hd)
        out = torch.cat([cls_out, out], dim=2)  # (B, h, N1, hd)
        return self.proj(out.transpose(1, 2).reshape(b, n1, dl))


class SpaceTimeBlock(nn.Module):
    """Pre-norm block: [time attention] -> space attention -> MLP.
    `span_names` (time, space), where given, names a span around each
    attention's forward and backward (utils/profiling.span_both_ways)."""

    def __init__(self, dim: int, num_heads: int, time_module: Optional[str] = None,
                 attn_impl: str = "dense",
                 compute_dtype: torch.dtype = torch.float32,
                 norm_dtype: torch.dtype = torch.float32,
                 span_names: Optional[Tuple[str, str]] = None):
        super().__init__()
        self.span_names = span_names
        self.has_time = time_module == "timeattn"
        if self.has_time:
            self.norm3 = LayerNormFp32(dim, compute_dtype=norm_dtype)
            self.timeattn = VarAttention(dim, num_heads, attn_impl, compute_dtype)
        self.norm1 = LayerNormFp32(dim, compute_dtype=norm_dtype)
        self.attn = VarAttention(dim, num_heads, attn_impl, compute_dtype)
        self.norm2 = LayerNormFp32(dim, compute_dtype=norm_dtype)
        self.mlp = Mlp(dim, MLP_RATIO * dim, compute_dtype)

    def _attend(self, which: int, attn, y, add_mask, mode: str, frames: int, patches: int):
        if self.span_names is None:
            return attn(y, add_mask, mode, frames, patches)
        return profiling.span_both_ways(self.span_names[which], attn, y, add_mask, mode,
                                        frames, patches)

    def forward(self, x, add_mask, frames: int, patches: int):
        if self.has_time:
            t = self._attend(0, self.timeattn, self.norm3(x), add_mask, "time", frames, patches)
            time_residual = x + t
        else:
            time_residual = x
        s = self._attend(1, self.attn, self.norm1(time_residual), add_mask, "space", frames,
                         patches)
        space_residual = x + s  # from the ORIGINAL x
        return space_residual + self.mlp(self.norm2(space_residual))


class ObjectTransformer(nn.Module):
    """Region tower: (B, F, K, 2054) features + (B, F, K) binary mask ->
    (embeddings (B, 1+F*K, output_dim), additive mask (B, 1+F*K))."""

    def __init__(self, region_nums: int = 20, num_frames: int = 4,
                 output_dim: int = 256, time_module: Optional[str] = None,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 attn_impl: str = "dense",
                 compute_dtype: torch.dtype = torch.float32, remat: bool = False,
                 norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.remat = remat
        d = embed_dim
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        # row 0 is the CLS position embed; rows 1: are kept for the
        # checkpoint layout but never added
        self.custom_pos_embed = nn.Parameter(torch.zeros(1, region_nums + 1, d))
        self.temporal_embed = nn.Parameter(torch.zeros(1, num_frames, d))
        self.object_embedding = Dense(APPEARANCE_DIM, d, compute_dtype=compute_dtype)
        self.pos_embedding = Dense(GEOMETRY_DIM, d, compute_dtype=compute_dtype)
        self.blocks = nn.ModuleList(
            SpaceTimeBlock(d, num_heads, time_module, attn_impl, compute_dtype, norm_dtype)
            for _ in range(depth)
        )
        self.proj = Dense(d, output_dim, bias=False, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor):
        b, f, k, _ = x.shape
        d = self.cls_token.shape[-1]
        cd = self.compute_dtype
        x = x.to(cd)
        tokens = self.object_embedding(x[..., :APPEARANCE_DIM])
        tokens = tokens + self.pos_embedding(x[..., APPEARANCE_DIM:])
        tokens = tokens.reshape(b, f * k, d)
        cls = self.cls_token.to(cd).expand(b, 1, d)
        h = torch.cat([cls, tokens], dim=1)
        mask = torch.cat(
            [torch.ones((b, 1), dtype=x_mask.dtype, device=x_mask.device),
             x_mask.reshape(b, f * k)], dim=1,
        )
        add_mask = additive_mask(mask)  # (B, 1+F*K): 0 / -100
        tile_temporal = self.temporal_embed[:, :f].repeat_interleave(k, dim=1)
        pos = torch.cat([self.custom_pos_embed[:, :1], tile_temporal], dim=1)
        h = h + pos.to(cd)
        for blk in self.blocks:
            if self.remat and torch.is_grad_enabled():
                h = checkpoint(blk, h, add_mask, f, k, use_reentrant=False,
                               preserve_rng_state=True)
            else:
                h = blk(h, add_mask, f, k)
        return self.proj(h), add_mask
