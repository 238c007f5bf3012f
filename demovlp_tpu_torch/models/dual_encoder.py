"""Dual-encoder retrieval model (counterpart of ObjectRelation in
demovlp_tpu/models/dual_encoder.py).

Text side: DistilBERT last hidden state -> `txt_proj = Sequential(ReLU,
Linear)`; the CLS row is the global text embedding, the other rows the
local word embeddings. Region side: ObjectTransformer; CLS row global, the
rest local. The forward returns the five-tensor dict with the object mask's
CLS column trimmed. The MLM head and the QA/MC models wait for later slices.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from demovlp_tpu_torch.models.distilbert import DistilBertConfig, DistilBertModel
from demovlp_tpu_torch.models.layers import Dense, init_weights, trunc_normal_
from demovlp_tpu_torch.models.object_transformer import ObjectTransformer


class ObjectRelation(nn.Module):
    def __init__(self, object_num: int = 30, num_frames: int = 4,
                 time_module: Optional[str] = None, projection_dim: int = 256,
                 text_config: DistilBertConfig = DistilBertConfig(),
                 object_embed_dim: int = 768, object_depth: int = 12,
                 object_heads: int = 12, attn_impl: str = "dense",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.text_model = DistilBertModel(text_config, compute_dtype)
        self.txt_proj = nn.Sequential(
            nn.ReLU(),
            Dense(text_config.dim, projection_dim, compute_dtype=compute_dtype),
        )
        self.object_model = ObjectTransformer(
            region_nums=object_num, num_frames=num_frames,
            output_dim=projection_dim, time_module=time_module or None,
            embed_dim=object_embed_dim, depth=object_depth,
            num_heads=object_heads, attn_impl=attn_impl,
            compute_dtype=compute_dtype,
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded random init (see layers.init_weights)."""
        init_weights(self, generator)
        om = self.object_model
        trunc_normal_(om.cls_token.data, 0.02, generator)
        trunc_normal_(om.custom_pos_embed.data, 0.02, generator)
        nn.init.zeros_(om.temporal_embed)

    def compute_text(self, input_ids, attention_mask):
        t = self.txt_proj(self.text_model(input_ids, attention_mask))
        return t[:, 0], t[:, 1:]

    def compute_object(self, object_feat, object_mask):
        o, add_mask = self.object_model(object_feat, object_mask)
        return o[:, 0], o[:, 1:], add_mask

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """batch: input_ids (B,L), attention_mask (B,L), object (B,F,K,2054),
        object_mask (B,F,K) -> the five-tensor embedding dict."""
        g_t, l_t = self.compute_text(batch["input_ids"], batch["attention_mask"])
        g_o, l_o, add_mask = self.compute_object(batch["object"], batch["object_mask"])
        return dict(
            global_text_embeddings=g_t,
            local_text_embeddings=l_t,
            global_object_embeddings=g_o,
            local_object_embeddings=l_o,
            object_mask=add_mask[:, 1:],  # additive, CLS trimmed
        )
