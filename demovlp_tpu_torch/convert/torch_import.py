"""Loading a reference-schema checkpoint into a model with another frame
count (the port's copy of demovlp_tpu/convert/torch_import.py
`inflate_temporal_embed`, and the load path of demovlp_tpu/cli/common.py
`load_pretrained_into`).

A pre-training checkpoint at f = 1 frame carries a (1, 1, D) temporal
embed; a fine-tune model at f = 8 has a (1, 8, D) parameter. The embed is
resized along the frame axis per `arch.args.load_temporal_fix`:
  * "zeros" (default): the loaded frames first, zeros after them;
  * "interp": nearest, torch F.interpolate(mode="nearest"), source index
    floor(i * F_load / F);
  * "bilinear": F.interpolate(mode="bilinear", align_corners=False) over
    the (frames, D) plane, which resamples the frame axis only.
A checkpoint with more frames than the model is cut to the first F.

`import_timm_vit` initialises the region tower from a timm ViT (the
reference's non-strict load of a ViT-B/16 into its object transformer).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from demovlp_tpu_torch.convert.from_jax import load_reference_state_dict

TEMPORAL_KEY = "object_model.temporal_embed"
TEMPORAL_FIXES = ("zeros", "interp", "bilinear")


def inflate_temporal_embed(embed: np.ndarray, target_frames: int,
                           mode: str = "zeros") -> np.ndarray:
    """(1, F_load, D) -> (1, target_frames, D), numpy in and out."""
    load_frames = embed.shape[1]
    if load_frames == target_frames:
        return embed
    if load_frames > target_frames:
        return embed[:, :target_frames, :]
    if mode == "zeros":
        out = np.zeros((embed.shape[0], target_frames, embed.shape[2]), embed.dtype)
        out[:, :load_frames] = embed
        return out
    if mode not in ("interp", "bilinear"):
        raise NotImplementedError(f"load_temporal_fix {mode!r}: expected one of "
                                  f"{TEMPORAL_FIXES}")
    src = embed[0].astype(np.float32)  # (F_load, D)
    scale = load_frames / target_frames
    if mode == "interp":
        idx = np.minimum((np.arange(target_frames) * scale).astype(int), load_frames - 1)
        return src[idx][None].astype(embed.dtype)
    # half-pixel centres, clamped at the edges
    pos = np.clip((np.arange(target_frames) + 0.5) * scale - 0.5, 0, load_frames - 1)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, load_frames - 1)
    frac = (pos - lo)[:, None]
    return ((1 - frac) * src[lo] + frac * src[hi])[None].astype(embed.dtype)


def load_pretrained_state_dict(path: str, num_frames: int,
                               temporal_fix: str = "zeros") -> Dict[str, torch.Tensor]:
    """A reference-schema `.pth` (bare state dict or trainer checkpoint) as
    a state dict for a model of `num_frames` frames: DataParallel prefix
    stripped, never-applied keys dropped (`load_reference_state_dict`) and
    the temporal embed resized."""
    sd = load_reference_state_dict(path)
    if TEMPORAL_KEY in sd:
        embed = inflate_temporal_embed(sd[TEMPORAL_KEY].numpy(), num_frames, temporal_fix)
        sd[TEMPORAL_KEY] = torch.from_numpy(np.ascontiguousarray(embed))
    return sd


def load_pretrained(model: torch.nn.Module, path: str, num_frames: int,
                    temporal_fix: Optional[str] = None) -> None:
    """Load `path` into `model` strictly, after the frame resize: a missing
    or unexpected key raises, as the JAX loader's params would not fit the
    model either."""
    model.load_state_dict(load_pretrained_state_dict(path, num_frames, temporal_fix or "zeros"),
                          strict=True)


# per timm block: the parameters the region tower's block shares with it
_TIMM_BLOCK_KEYS = tuple(f"{m}.{p}" for m in ("norm1", "norm2", "attn.qkv", "attn.proj",
                                                "mlp.fc1", "mlp.fc2")
                         for p in ("weight", "bias"))


def _f32(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to(torch.float32, copy=True).cpu()
    return torch.from_numpy(np.array(v, dtype=np.float32))


def import_timm_vit(vit_state_dict: Mapping, state_dict: Mapping[str, torch.Tensor],
                    depth: int = 12) -> Dict[str, torch.Tensor]:
    """A new reference-schema state dict: `state_dict` with the region tower
    initialised from a timm ViT state dict (numpy arrays or tensors), as
    the JAX package's `import_timm_vit`: `cls_token` ->
    `object_model.cls_token`, and for each `blocks.{i}` (i < depth) present
    in the timm dict its norm1, norm2, attn.qkv, attn.proj, mlp.fc1 and
    mlp.fc2 weights and biases -> `object_model.blocks.{i}.*`. Blocks the
    timm dict lacks, and every other key (embeddings, projections), keep
    their values. A timm block the tower lacks raises KeyError."""
    out = dict(state_dict)
    if "cls_token" in vit_state_dict:
        out["object_model.cls_token"] = _f32(vit_state_dict["cls_token"])
    for i in range(depth):
        src = f"blocks.{i}."
        if f"{src}attn.qkv.weight" not in vit_state_dict:
            continue
        for key in _TIMM_BLOCK_KEYS:
            dst = f"object_model.blocks.{i}.{key}"
            if dst not in out:
                raise KeyError(f"{dst}: the region tower has no block {i} for timm's {src}")
            out[dst] = _f32(vit_state_dict[src + key])
    return out
