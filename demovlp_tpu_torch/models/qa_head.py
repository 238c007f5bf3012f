"""Bottom-Up-Top-Down video-QA head (counterpart of
demovlp_tpu/models/qa_head.py: `QAAttention`, `SimpleClassifier`,
`BUTDQAHead`). Module and parameter names follow the reference torch
schema (`head.v_att.v_proj.main.0.weight_g`, `head.classifier.main.3.bias`).

Reference behaviour kept:
  * question-guided region attention through weight-normed projections,
    with a MULTIPLICATIVE mask on the pre-softmax logits (logits * mask, not
    an additive -inf mask), then a softmax over the regions;
  * the classifier: the projected question times the projected attended
    region vector -> Linear -> ReLU -> Dropout -> Linear.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from demovlp_tpu_torch.models.layers import Dense, FCNet, WeightNormDense


class QAAttention(nn.Module):
    def __init__(self, v_dim: int, q_dim: int, hid_dim: int, glimpses: int = 1,
                 dropout: float = 0.2, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.v_proj = FCNet([v_dim, hid_dim], compute_dtype)
        self.q_proj = FCNet([q_dim, hid_dim], compute_dtype)
        self.dropout = nn.Dropout(dropout)
        self.linear = WeightNormDense(hid_dim, glimpses, compute_dtype=compute_dtype)

    def forward(self, v, v_mask, q):
        """v (B, K, v_dim); v_mask (B, K) binary; q (B, q_dim) ->
        (attention (B, K, glimpses), logits)."""
        joint = self.dropout(self.v_proj(v) * self.q_proj(q)[:, None, :])
        logits = self.linear(joint)
        logits = logits * v_mask[..., None].to(logits.dtype)
        return torch.softmax(logits, dim=1), logits


class SimpleClassifier(nn.Module):
    def __init__(self, q_dim: int, v_dim: int, hid_dim: int, out_dim: int,
                 dropout: float = 0.0, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.q_net = FCNet([q_dim, hid_dim], compute_dtype)
        self.v_net = FCNet([v_dim, hid_dim], compute_dtype)
        self.main = nn.Sequential(
            Dense(hid_dim, 2 * hid_dim, compute_dtype=compute_dtype),
            nn.ReLU(),
            nn.Dropout(dropout),
            Dense(2 * hid_dim, out_dim, compute_dtype=compute_dtype),
        )

    def forward(self, q_emb, v_emb):
        return self.main(self.q_net(q_emb) * self.v_net(v_emb))


class BUTDQAHead(nn.Module):
    def __init__(self, v_dim: int, q_dim: int, hid_dim: int, out_dim: int,
                 dropout: float = 0.2, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.v_att = QAAttention(v_dim, q_dim, hid_dim, dropout=dropout,
                                 compute_dtype=compute_dtype)
        self.classifier = SimpleClassifier(q_dim, v_dim, hid_dim, out_dim,
                                           compute_dtype=compute_dtype)

    def forward(self, txt_embed, obj_embed, obj_mask):
        """txt_embed (B, q_dim); obj_embed (B, K, v_dim); obj_mask (B, K)
        binary -> logits (B, out_dim)."""
        att, _ = self.v_att(obj_embed, obj_mask, txt_embed)
        pooled = torch.sum(att * obj_embed, dim=1)
        return self.classifier(txt_embed, pooled)
