"""Frozen in Time (Bain, Nagrani, Varol, Zisserman, ICCV 2021,
arXiv:2104.00650; github.com/m-bain/frozen-in-time `FrozenInTime` and
`SpaceTimeTransformer`): a ViT video tower with divided space-time
attention over raw frames beside the DistilBERT text tower, each projected
to the joint space; trained with NormSoftmax (InfoNCE) on the global
embeddings alone.

Video tower (`VideoTransformer`, Frozen's `SpaceTimeTransformer`):
  * pixels (B, F, 3, H, W) arrive as uint8 and are normalised on the card:
    x / 255, then ImageNet's mean and std (Frozen's transforms);
  * each frame's P x P patches are embedded by Frozen's Conv2d(3, D, P,
    stride P), held as the Linear of its flattened kernel
    (`patch_embed.proj.weight` (D, 3 P P) is conv.weight.reshape(D, -1)):
    the same products, as one GEMM;
  * CLS + pos_embed[0]; the F N patch tokens + pos_embed[1:] tiled over the
    frames + temporal_embed repeated over each frame's N patches;
  * `depth` of the port's SpaceTimeBlock with time attention on: time
    attention (each patch position over its F frames and CLS), then space
    attention (each frame's N patches and CLS), the space branch adding to
    the block's input, CLS attending over every token (Frozen's
    "frozen-in-time" style), always in the grouped form (`attn_impl`
    "xla"): the dense block-bias form would hold 785 x 785 logits a head;
  * a final LayerNorm (eps 1e-6) and the CLS row.
`vid_proj` is Linear(D -> projection_dim); the text embedding is
DistilBERT's CLS row through `txt_proj` (ReLU, Linear).

Departures from Frozen: the towers' products run in the config's compute
dtype (bf16 in the shipped config, as in the port's other configs), norms
and softmax in f32; the video tower has no dropout or drop-path, as the
port's region tower has none; time attention's projection is drawn from
the seed like every other Linear, where Frozen's `time_init: "zeros"`
zeroes it to start from an image checkpoint.

Spans (utils/profiling.py, only under a profiler session):
`video.patch_embed` (normalisation and patch embedding, forward),
`video.time_attn` and `video.space_attn` (each block's attentions, forward
and backward); counter `video.tokens` (video tokens a forward).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from demovlp_tpu_torch.models.distilbert import DistilBertConfig, DistilBertModel
from demovlp_tpu_torch.models.layers import Dense, LayerNormFp32, init_weights, trunc_normal_
from demovlp_tpu_torch.models.object_transformer import SpaceTimeBlock
from demovlp_tpu_torch.utils import profiling

#: ImageNet's per-channel mean and std of x / 255, as Frozen's transforms normalise
PIXEL_MEAN = (0.485, 0.456, 0.406)
PIXEL_STD = (0.229, 0.224, 0.225)
#: Frozen's `arch_config` names: (patch_size, resolution, embed_dim, depth, heads)
ARCH_CONFIGS = {"base_patch16_224": (16, 224, 768, 12, 12)}
SPANS = ("video.time_attn", "video.space_attn")


class PatchEmbed(nn.Module):
    """Normalise uint8 frames and embed their P x P patches: (B, F, C, H, W)
    -> (B, F N, D) in the compute dtype."""

    def __init__(self, patch_size: int, embed_dim: int, in_chans: int = 3,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Dense(in_chans * patch_size * patch_size, embed_dim,
                          compute_dtype=compute_dtype)
        # (mean, 1 / std) of the 0-255 values by device: constants, not
        # buffers, so a model given storage on the card (`to_empty`) has them
        self._scale: Dict[torch.device, tuple] = {}

    def _normaliser(self, device: torch.device):
        if device not in self._scale:
            mean = torch.tensor(PIXEL_MEAN).view(1, 1, -1, 1, 1) * 255.0
            std = torch.tensor(PIXEL_STD).view(1, 1, -1, 1, 1) * 255.0
            self._scale[device] = (mean.to(device), (1.0 / std).to(device))
        return self._scale[device]

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        b, f, c, h, w = video.shape
        p = self.patch_size
        mean, inv_std = self._normaliser(video.device)
        x = (video.float() - mean) * inv_std
        x = x.to(self.proj.compute_dtype)
        # (B, F, C, H/P, P, W/P, P) -> (B, F, H/P, W/P, C, P, P): the conv's patch order
        x = x.reshape(b, f, c, h // p, p, w // p, p).permute(0, 1, 3, 5, 2, 4, 6)
        return self.proj(x.reshape(b, f * (h // p) * (w // p), c * p * p))


class VideoTransformer(nn.Module):
    """Frozen's SpaceTimeTransformer: uint8 (B, F, 3, H, W) -> the CLS row
    after the final norm, (B, D) in the compute dtype."""

    def __init__(self, num_frames: int = 4, resolution: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 compute_dtype: torch.dtype = torch.float32,
                 norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        if resolution % patch_size:
            raise ValueError(f"resolution {resolution} is not a multiple of the patch "
                             f"size {patch_size}")
        self.compute_dtype = compute_dtype
        self.num_frames = num_frames
        self.patches_per_frame = (resolution // patch_size) ** 2
        d = embed_dim
        self.patch_embed = PatchEmbed(patch_size, d, compute_dtype=compute_dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.patches_per_frame + 1, d))
        self.temporal_embed = nn.Parameter(torch.zeros(1, num_frames, d))
        self.blocks = nn.ModuleList(
            SpaceTimeBlock(d, num_heads, "timeattn", "xla", compute_dtype, norm_dtype,
                           span_names=SPANS)
            for _ in range(depth))
        self.norm = LayerNormFp32(d, eps=1e-6, compute_dtype=norm_dtype)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        b, f = video.shape[:2]
        if f > self.num_frames:
            raise ValueError(f"{f} frames; the temporal embed holds {self.num_frames}")
        n = self.patches_per_frame
        cd = self.compute_dtype
        profiling.count("video.tokens", b * (1 + f * n))
        with profiling.span("video.patch_embed"):
            tokens = self.patch_embed(video)
        d = tokens.shape[-1]
        if tokens.shape[1] != f * n:
            raise ValueError(f"{tokens.shape[1] // f} patches a frame; the model holds {n}")
        pos = self.pos_embed[:, 1:].repeat(1, f, 1)
        pos = pos + self.temporal_embed[:, :f].repeat_interleave(n, dim=1)
        x = torch.cat([self.cls_token.to(cd).expand(b, 1, d) + self.pos_embed[:, :1].to(cd),
                       tokens + pos.to(cd)], dim=1)
        add_mask = torch.zeros((b, 1 + f * n), dtype=torch.float32, device=x.device)
        for blk in self.blocks:
            x = blk(x, add_mask, f, n)
        return self.norm(x[:, 0])


class FrozenInTime(nn.Module):
    """The dual encoder: forward(batch) -> {"global_text_embeddings",
    "global_object_embeddings"} (the video's, under the retrieval step's
    key), each (B, projection_dim)."""

    def __init__(self, num_frames: int = 4, resolution: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 projection_dim: int = 256,
                 text_config: DistilBertConfig = DistilBertConfig(),
                 compute_dtype: torch.dtype = torch.float32,
                 norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.text_model = DistilBertModel(text_config, compute_dtype, norm_dtype)
        self.txt_proj = nn.Sequential(
            nn.ReLU(), Dense(text_config.dim, projection_dim, compute_dtype=compute_dtype))
        self.video_model = VideoTransformer(num_frames, resolution, patch_size, embed_dim,
                                            depth, num_heads, compute_dtype, norm_dtype)
        self.vid_proj = nn.Sequential(Dense(embed_dim, projection_dim,
                                            compute_dtype=compute_dtype))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded random init (layers.init_weights); CLS and position
        embeds truncated normal 0.02, the temporal embed zeros (Frozen's)."""
        init_weights(self, generator)
        vm = self.video_model
        trunc_normal_(vm.cls_token.data, 0.02, generator)
        trunc_normal_(vm.pos_embed.data, 0.02, generator)
        nn.init.zeros_(vm.temporal_embed)

    def compute_text(self, input_ids, attention_mask) -> torch.Tensor:
        return self.txt_proj(self.text_model(input_ids, attention_mask)[:, 0])

    def compute_video(self, video) -> torch.Tensor:
        return self.vid_proj(self.video_model(video))

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return dict(global_text_embeddings=self.compute_text(batch["input_ids"],
                                                             batch["attention_mask"]),
                    global_object_embeddings=self.compute_video(batch["video"]))
