"""FLOP model and MFU (counterpart of demovlp_tpu/utils/flops.py).

Two FLOP sources, cross-checkable against each other:

  * `step_flops` — torch's FlopCounterMode over one call of a step: the
    matrix products, convolutions and attention of the aten ops that ran
    (forward and, where the step runs it, backward). It cannot see the
    hand-written kernels called through ctypes (ops/xattn_kernel.py), so
    on the card a step with the local loss counts its towers and global
    sims only.
  * `retrieval_step_flops_model` — the analytic model: two transformer
    towers forward and backward (backward = 2x forward), the global sims
    and the O(B^2) local cross-attention, arithmetic for arithmetic the
    JAX package's. With the local loss it is the basis of MFU, and
    `step_flops` the cross-check on the towers.

MFU = (FLOP/s on one card) / (that card's published dense bf16 peak).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

# published dense bf16 TFLOP/s by torch.cuda.get_device_name prefix:
# the H100 SXM part (NVIDIA's H100 data sheet, without sparsity)
_PEAK_BF16_TFLOPS = (
    ("NVIDIA H100 80GB HBM3", 989.0),
)


def peak_bf16_flops(device) -> Optional[float]:
    """Dense bf16 FLOP/s of the card `device` names; None for the CPU and
    for a card not in the table."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for prefix, tflops in _PEAK_BF16_TFLOPS:
        if name.startswith(prefix):
            return tflops * 1e12
    return None


def step_flops(fn: Callable, *args, **kwargs) -> float:
    """FLOPs of the aten ops of one call `fn(*args, **kwargs)`, by
    torch.utils.flop_counter.FlopCounterMode (products, convolutions,
    attention; elementwise ops count 0). Kernels called through ctypes are
    not seen (module docstring)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def _transformer_tower_flops(seq: int, d: int, ffn: int, layers: int) -> float:
    """Forward flops of one encoder stack on one sequence (matmul 2*MACs;
    norms/softmax/elementwise omitted — O(1%) at these shapes):
    qkv+out projections 4*seq*d^2, attention 2*seq^2*d (QK^T + AV),
    ffn 2*seq*d*ffn."""
    per_layer = (
        4 * seq * d * d * 2       # q,k,v,out projections
        + 2 * seq * seq * d * 2   # scores + context
        + 2 * seq * d * ffn * 2   # two ffn matmuls
    )
    return float(layers * per_layer)


def retrieval_step_flops_model(
    global_b: int,
    frames: int,
    regions: int,
    text_len: int,
    proj_dim: int = 256,
    obj_depth: int = 12,
    obj_dim: int = 768,
    text_layers: int = 6,
    text_dim: int = 768,
    use_local: bool = True,
) -> float:
    """Analytic flops for one pre-train step (both towers fwd+bwd + global
    sims + O(B^2) local RWA loss). bwd = 2x fwd for every matmul-dominated
    piece; the AdamW elementwise update and host-side pieces are omitted
    (sub-1%)."""
    obj_seq = frames * regions + 1
    obj_fwd = _transformer_tower_flops(obj_seq, obj_dim, 4 * obj_dim, obj_depth)
    # input embed: 2054 -> 768 (+ 6-d geometry, negligible) and 768 -> proj
    obj_fwd += frames * regions * 2054 * obj_dim * 2
    obj_fwd += obj_seq * obj_dim * proj_dim * 2
    txt_fwd = _transformer_tower_flops(text_len, text_dim, 4 * text_dim,
                                       text_layers)
    txt_fwd += text_len * text_dim * proj_dim * 2
    towers = 3.0 * global_b * (obj_fwd + txt_fwd)  # fwd + bwd(2x)

    # global sim matrix (B x B x proj) fwd+bwd
    sims = 3.0 * 2 * global_b * global_b * proj_dim

    local = 0.0
    if use_local:
        # RWA cross-attention per (video, text) pair (ops/xattn.py):
        # scores (L_t x L_r) = 2*Lt*Lr*d, re-attended context = 2*Lt*Lr*d,
        # cosine row similarities ~ 2*Lt*d; computed for BOTH directions
        # (i2t + t2i) over B^2 pairs, fwd+bwd.
        lt, lr = text_len - 1, frames * regions
        per_pair = 2 * (2 * lt * lr * proj_dim * 2 + 2 * lt * proj_dim)
        local = 3.0 * global_b * global_b * per_pair

    return towers + sims + local


def mfu(flops_per_sec: float, device) -> Optional[float]:
    """The share of the card's dense bf16 peak that `flops_per_sec` is,
    for f32 steps too (the JAX package's definition: one peak a card);
    None where the peak is unknown (the CPU, an unlisted card)."""
    peak = peak_bf16_flops(device)
    if not peak:
        return None
    return flops_per_sec / peak
