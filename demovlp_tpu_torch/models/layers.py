"""Shared model layers (counterpart of demovlp_tpu/models/layers.py:
`LayerNormFp32`, `Mlp`, `WeightNormDense`, `FCNet`, `trunc_normal_init`),
plus `Dense`, the Linear that computes in the model's compute dtype.

Parameters always stay float32, as in the JAX package (param_dtype f32);
a bf16 model casts weights and inputs to bf16 at each product.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class Dense(nn.Linear):
    """nn.Linear whose product runs in `compute_dtype` (flax Dense(dtype=...))."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        b = None if self.bias is None else self.bias.to(cd)
        return F.linear(x.to(cd), self.weight.to(cd), b)


class LayerNormFp32(nn.LayerNorm):
    """LayerNorm with f32 params and a compute dtype (`precision.norm`, JAX
    `LayerNormFp32(dtype=...)`); the result is cast back to the input's
    dtype. float32, the default, keeps the reference's f32 statistics under
    any model compute dtype (one layer_norm kernel). bfloat16 takes the
    norm as flax's LayerNorm(dtype=bf16, force_float32_reductions=False)
    does: the input cast to bf16; E[x] and E[x^2] (of the bf16 squares)
    each accumulated in f32 and rounded to bf16; var = max(0, E[x^2] -
    E[x]^2), x - E[x] and rsqrt(var + eps) in bf16 (each rounded once); then
    the f32 scale and bias applied in f32 and one rounding to bf16. It is a composition of
    elementwise ops and two reductions, so it costs launches where the f32
    norm is one kernel: an option for the JAX package's numerics, not for
    speed. Region-tower eps is 1e-6."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        if cd == torch.float32:
            y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
            return y.to(x.dtype)
        h = x.to(cd)
        mu = h.float().mean(-1, keepdim=True).to(cd)
        mu2 = (h * h).float().mean(-1, keepdim=True).to(cd)
        var = torch.clamp(mu2 - mu * mu, min=0.0) + self.eps
        # rsqrt taken in f32 and rounded (torch's bf16 rsqrt on the CPU is off by an ulp)
        mul = torch.rsqrt(var.float()).to(cd).float() * self.weight
        y = (h - mu).float() * mul + self.bias
        return y.to(cd).to(x.dtype)


class Mlp(nn.Module):
    """Dense -> exact GELU -> Dense (dropout is off when serving)."""

    def __init__(self, dim: int, hidden_dim: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(dim, hidden_dim, compute_dtype=compute_dtype)
        self.fc2 = Dense(hidden_dim, dim, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class WeightNormDense(nn.Module):
    """Linear with weight normalisation over the whole matrix (torch
    weight_norm(..., dim=None)): w = g v / max(|v|_F, 1e-12), g a scalar;
    the product in `compute_dtype`. Keys weight_g, weight_v, bias."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight_g = nn.Parameter(torch.ones(()))
        self.weight_v = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """lecun-normal v and g = |v|_F, so the weight equals v at init."""
        trunc_normal_(self.weight_v, 1.0 / math.sqrt(self.weight_v.shape[1]) / 0.87962566,
                      generator)
        with torch.no_grad():
            self.weight_g.copy_(torch.linalg.norm(self.weight_v))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        w = self.weight_g / torch.clamp(torch.linalg.norm(self.weight_v), min=1e-12) * self.weight_v
        b = None if self.bias is None else self.bias.to(cd)
        return F.linear(x.to(cd), w.to(cd), b)


class FCNet(nn.Module):
    """(weight-normed Linear -> ReLU) stack over dims [in, hidden..., out];
    `main` holds them as the reference's Sequential (Linears at even
    indices)."""

    def __init__(self, dims, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        layers = []
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            layers += [WeightNormDense(d_in, d_out, compute_dtype=compute_dtype), nn.ReLU()]
        self.main = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.main(x)


def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """Normal(0, std) truncated to [-2 std, 2 std], as flax's
    truncated_normal(stddev=std, lower=-2, upper=2) draws it."""
    with torch.no_grad():
        t.normal_(0.0, 1.0, generator=generator)
        while True:
            bad = t.abs() > 2.0
            if not bad.any():
                break
            t[bad] = torch.randn(int(bad.sum()), generator=generator,
                                 dtype=t.dtype, device=t.device)
        return t.mul_(std)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init in the spirit of the JAX package's initialisers:
    lecun-normal Linear kernels (std 1/sqrt(fan_in), truncated), zero
    biases, unit LayerNorms, embeddings N(0, 1/dim). Parameters the model
    names itself (cls token, position embeds) are set by the model."""
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            # flax lecun_normal: truncated normal rescaled to unit variance
            trunc_normal_(mod.weight, 1.0 / math.sqrt(mod.in_features) / 0.87962566,
                          generator)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, WeightNormDense):
            mod.reset_parameters(generator)
        elif isinstance(mod, nn.LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.Embedding):
            with torch.no_grad():
                mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.embedding_dim),
                                   generator=generator)
