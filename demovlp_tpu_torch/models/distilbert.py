"""DistilBERT text tower (counterpart of demovlp_tpu/models/distilbert.py).

Module names follow the reference torch schema (HF DistilBERT:
`embeddings.word_embeddings`, `transformer.layer.N.attention.q_lin`, ...),
so a reference-schema state dict loads with strict=True.

Numerics kept from the JAX tower: embeddings are gathered and normalised in
f32 and only then cast to the compute dtype; q is divided by sqrt(head_dim)
in the compute dtype; padded keys get a -1e9 bias; attention logits and
softmax are f32 and the probabilities are cast to the compute dtype before
the PV product; GELU is exact; LayerNorm eps is 1e-12, its statistics in
`norm_dtype` (f32 by default; `precision.norm: "bfloat16"` normalises in
bf16 where JAX passes its `norm_dtype`: the embedding norm and both norms
of every block).

Dropout (p = 0.1, active only in `train()` mode, drawn from torch's global
generator, which the train step seeds per step: train/steps.py) sits where
the JAX tower has it: on the embeddings after their LayerNorm, on the
attention probabilities, and on the FFN output. There is none on `out_lin`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from demovlp_tpu_torch.models.layers import Dense, LayerNormFp32


@dataclass(frozen=True)
class DistilBertConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 6
    n_heads: int = 12
    hidden_dim: int = 3072
    max_position_embeddings: int = 512
    dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12


class Embeddings(nn.Module):
    def __init__(self, cfg: DistilBertConfig, norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.dim)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.dim)
        self.LayerNorm = LayerNormFp32(cfg.dim, eps=cfg.layer_norm_eps, compute_dtype=norm_dtype)
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)[None]
        return self.dropout(self.LayerNorm(x))  # f32


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, cfg: DistilBertConfig, compute_dtype: torch.dtype):
        super().__init__()
        self.n_heads = cfg.n_heads
        self.compute_dtype = compute_dtype
        self.dropout = nn.Dropout(cfg.attention_dropout)
        for name in ("q_lin", "k_lin", "v_lin", "out_lin"):
            setattr(self, name, Dense(cfg.dim, cfg.dim, compute_dtype=compute_dtype))

    def forward(self, x: torch.Tensor, add_bias: torch.Tensor) -> torch.Tensor:
        b, length, dim = x.shape
        hd = dim // self.n_heads
        cd = self.compute_dtype

        def heads(t):  # (B, L, D) -> (B, h, L, hd); h is local under TP (parallel/tp.py)
            return t.reshape(b, length, -1, hd).transpose(1, 2)

        scale = torch.tensor(math.sqrt(hd), dtype=torch.float32).to(cd)
        q = heads(self.q_lin(x)) / scale
        k = heads(self.k_lin(x))
        v = heads(self.v_lin(x))
        # f32 logits over compute-dtype operands (f32 accumulation)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + add_bias
        probs = self.dropout(torch.softmax(logits, dim=-1).to(cd))
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, length, -1)
        return self.out_lin(out)


class FFN(nn.Module):
    def __init__(self, cfg: DistilBertConfig, compute_dtype: torch.dtype):
        super().__init__()
        self.lin1 = Dense(cfg.dim, cfg.hidden_dim, compute_dtype=compute_dtype)
        self.lin2 = Dense(cfg.hidden_dim, cfg.dim, compute_dtype=compute_dtype)
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(self.lin2(F.gelu(self.lin1(x), approximate="none")))


class TransformerBlock(nn.Module):
    def __init__(self, cfg: DistilBertConfig, compute_dtype: torch.dtype,
                 norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attention = MultiHeadSelfAttention(cfg, compute_dtype)
        self.sa_layer_norm = LayerNormFp32(cfg.dim, eps=cfg.layer_norm_eps,
                                           compute_dtype=norm_dtype)
        self.ffn = FFN(cfg, compute_dtype)
        self.output_layer_norm = LayerNormFp32(cfg.dim, eps=cfg.layer_norm_eps,
                                               compute_dtype=norm_dtype)

    def forward(self, x: torch.Tensor, add_bias: torch.Tensor) -> torch.Tensor:
        x = self.sa_layer_norm(x + self.attention(x, add_bias))
        return self.output_layer_norm(x + self.ffn(x))


class Transformer(nn.Module):
    def __init__(self, cfg: DistilBertConfig, compute_dtype: torch.dtype,
                 norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer = nn.ModuleList(
            TransformerBlock(cfg, compute_dtype, norm_dtype) for _ in range(cfg.n_layers)
        )

    def forward(self, x: torch.Tensor, add_bias: torch.Tensor) -> torch.Tensor:
        for blk in self.layer:
            x = blk(x, add_bias)
        return x


class DistilBertModel(nn.Module):
    def __init__(self, cfg: DistilBertConfig = DistilBertConfig(),
                 compute_dtype: torch.dtype = torch.float32,
                 norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = cfg
        self.compute_dtype = compute_dtype
        self.embeddings = Embeddings(cfg, norm_dtype)
        self.transformer = Transformer(cfg, compute_dtype, norm_dtype)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """input_ids (B, L) int; attention_mask (B, L) 1/0 ->
        last hidden state (B, L, dim) in the compute dtype."""
        x = self.embeddings(input_ids).to(self.compute_dtype)
        add_bias = torch.where(
            attention_mask[:, None, None, :] > 0,
            torch.zeros((), dtype=torch.float32, device=x.device),
            torch.full((), -1e9, dtype=torch.float32, device=x.device),
        )
        return self.transformer(x, add_bias)
