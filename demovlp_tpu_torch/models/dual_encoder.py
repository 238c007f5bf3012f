"""The model families (counterpart of demovlp_tpu/models/dual_encoder.py:
`ObjectRelation`, `ObjectQARelation`, `ObjectMCRelation`).

Text side: DistilBERT last hidden state -> `txt_proj = Sequential(ReLU,
Linear)`; the CLS row is the global text embedding, the other rows the
local word embeddings. Region side: ObjectTransformer; CLS row global, the
rest local. The retrieval forward returns the five-tensor dict with the
object mask's CLS column trimmed. QA max-pools the projected text over ALL
positions, padded ones included (reference model.py:286), and runs the BUTD
head over the non-CLS region embeddings with the BINARY region mask
flattened to (B, F*K). MC is the retrieval architecture, scored per option.

With `with_mlm` the retrieval model carries the MLM head on DistilBERT's
last hidden state (Hugging Face DistilBertForMaskedLM's names:
`mlm_head.vocab_transform`, `vocab_layer_norm`, `vocab_projector`); only a
forward that asks for it (`mlm=True`, the MLM train step) runs it, so eval
and serving never pay for the vocabulary projection.

`norm_dtype` (`precision.norm`) is the LayerNorm compute dtype of both
towers, as JAX passes it; the MLM head's norm stays f32, as in JAX.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from demovlp_tpu_torch.models.distilbert import DistilBertConfig, DistilBertModel
from demovlp_tpu_torch.models.layers import Dense, LayerNormFp32, init_weights, trunc_normal_
from demovlp_tpu_torch.models.object_transformer import ObjectTransformer
from demovlp_tpu_torch.models.qa_head import BUTDQAHead


class MLMHead(nn.Module):
    """Masked-LM head: Linear(dim, dim) -> exact GELU -> LayerNorm (f32
    statistics, the result in the compute dtype) -> Linear(dim, vocab)."""

    def __init__(self, vocab_size: int, dim: int, layer_norm_eps: float = 1e-12,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vocab_transform = Dense(dim, dim, compute_dtype=compute_dtype)
        self.vocab_layer_norm = LayerNormFp32(dim, eps=layer_norm_eps)
        self.vocab_projector = Dense(dim, vocab_size, compute_dtype=compute_dtype)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        x = torch.nn.functional.gelu(self.vocab_transform(hidden), approximate="none")
        return self.vocab_projector(self.vocab_layer_norm(x))


class ObjectRelation(nn.Module):
    def __init__(self, object_num: int = 30, num_frames: int = 4,
                 time_module: Optional[str] = None, projection_dim: int = 256,
                 text_config: DistilBertConfig = DistilBertConfig(),
                 object_embed_dim: int = 768, object_depth: int = 12,
                 object_heads: int = 12, attn_impl: str = "dense",
                 compute_dtype: torch.dtype = torch.float32, with_mlm: bool = False,
                 remat: bool = False, norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.text_model = DistilBertModel(text_config, compute_dtype, norm_dtype)
        self.txt_proj = nn.Sequential(
            nn.ReLU(),
            Dense(text_config.dim, projection_dim, compute_dtype=compute_dtype),
        )
        self.object_model = ObjectTransformer(
            region_nums=object_num, num_frames=num_frames,
            output_dim=projection_dim, time_module=time_module or None,
            embed_dim=object_embed_dim, depth=object_depth,
            num_heads=object_heads, attn_impl=attn_impl,
            compute_dtype=compute_dtype, remat=remat, norm_dtype=norm_dtype,
        )
        # registered last, so the seeded init of the other parameters is
        # the same with and without the head
        self.mlm_head = (MLMHead(text_config.vocab_size, text_config.dim,
                                 text_config.layer_norm_eps, compute_dtype)
                         if with_mlm else None)

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

    def forward(self, batch: Dict[str, torch.Tensor],
                mlm: bool = False) -> Dict[str, torch.Tensor]:
        """batch: input_ids (B,L), attention_mask (B,L), object (B,F,K,2054),
        object_mask (B,F,K) -> the five-tensor embedding dict, plus
        `mlm_logits` (B, L, vocab) when `mlm` (the model needs the head)."""
        hidden = self.text_model(batch["input_ids"], batch["attention_mask"])
        t = self.txt_proj(hidden)
        g_o, l_o, add_mask = self.compute_object(batch["object"], batch["object_mask"])
        out = dict(
            global_text_embeddings=t[:, 0],
            local_text_embeddings=t[:, 1:],
            global_object_embeddings=g_o,
            local_object_embeddings=l_o,
            object_mask=add_mask[:, 1:],  # additive, CLS trimmed
        )
        if mlm:
            if self.mlm_head is None:
                raise ValueError("mlm=True needs a model built with_mlm")
            out["mlm_logits"] = self.mlm_head(hidden)
        return out


class ObjectQARelation(ObjectRelation):
    """Video-QA model: the towers and the BUTD head; forward -> {"logits"}."""

    def __init__(self, num_label: int = 1500, head_dropout: float = 0.2, **kwargs):
        super().__init__(**kwargs)
        dim = kwargs.get("projection_dim", 256)
        self.head = BUTDQAHead(v_dim=dim, q_dim=dim, hid_dim=dim, out_dim=num_label,
                               dropout=head_dropout,
                               compute_dtype=kwargs.get("compute_dtype", torch.float32))

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        text = self.txt_proj(self.text_model(batch["input_ids"], batch["attention_mask"]))
        obj, _ = self.object_model(batch["object"], batch["object_mask"])
        text_pooled = torch.amax(text, dim=1)  # padded positions included
        flat_mask = batch["object_mask"].reshape(obj.shape[0], -1)
        return dict(logits=self.head(text_pooled, obj[:, 1:], flat_mask))


class ObjectMCRelation(ObjectRelation):
    """Multiple-choice model: the retrieval architecture, scored by
    option-expanded similarity (train/steps.py)."""
