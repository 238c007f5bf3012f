"""Grouped masked attention: the CUDA kernel's wrapper, its plain PyTorch
version and the trainable Function (counterpart of
demovlp_tpu/ops/pallas_attention.py: `_attn_kernel` via
`grouped_attention_pallas`, `grouped_attention_xla`,
`grouped_attention_fused`).

    out = softmax(q k^T + bias) v over G groups
    q (G, Lq, hd) with any scale already applied, k and v (G, Lk, hd),
    bias (G, Lk) additive; out (G, Lq, hd) in q's dtype.

Numerics as in the JAX op: logits and softmax in f32 with the row maximum
subtracted, the probabilities cast to v's dtype, the second product
accumulated in f32 and the result cast to q's dtype; f32 and bf16 inputs.

`grouped_attention` dispatches on the tensor's device: a CPU tensor goes to
`grouped_attention_plain`, a CUDA tensor to the kernel in
csrc/grouped_attention.cu (built at first use), anything else raises. The
kernel takes the group's keys as they are, with no padding, so it follows
`grouped_attention_xla` where the Pallas wrapper does not: a group whose
every key has a bias of -1e9 or less averages over its own keys there,
while the Pallas kernel, which pads Lk to 128 lanes with -1e9, averages
over the padding too.

As in the JAX package this op is not a model option: `ObjectTransformer`
runs its own "dense" and "xla" forms, and `attn_impl: "pallas"` is
rejected when a model is built.
"""
from __future__ import annotations

import ctypes

import torch

from demovlp_tpu_torch.ops import cuda_build

KERNEL = "grouped_attention"

#: launcher calls since the last reset (callers reset it around the run
#: they want to read); one count is one grouped_attention_kernel launch
LAUNCHES = {KERNEL: 0}

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_counts() -> None:
    LAUNCHES[KERNEL] = 0


def grouped_attention_plain(q, k, v, bias):
    """Plain PyTorch version: the JAX package's `grouped_attention_xla`.
    On the card, run it with TF32 off (device.resolve_device does)."""
    logits = torch.einsum("gqd,gkd->gqk", q.float(), k.float()) + bias[:, None, :].float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("gqk,gkd->gqd", probs.float(), v.float()).to(q.dtype)


def _check(q, k, v, bias):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or bias.dim() != 2:
        raise ValueError("expected q (G,Lq,hd), k and v (G,Lk,hd), bias (G,Lk)")
    g, _, hd = q.shape
    if k.shape != v.shape or k.shape[0] != g or k.shape[2] != hd or tuple(bias.shape) != (
            g, k.shape[1]):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, bias {tuple(bias.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of {_DTYPES}: "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def grouped_attention_kernel(q, k, v, bias):
    """The kernel on CUDA tensors (no autograd); bias is taken as f32."""
    bias = bias.float().contiguous()
    _check(q, k, v, bias)
    g, lq, hd = q.shape
    lk = k.shape[1]
    out = torch.empty_like(q)
    if g == 0 or lq == 0:
        return out
    fn = getattr(cuda_build.load(KERNEL), KERNEL)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                 g, lq, lk, hd, int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        # cudaErrorInvalidValue (1): one group's keys and values do not fit
        # one block's shared memory
        raise RuntimeError(f"grouped_attention launch failed (Lk={lk}, hd={hd}): "
                           f"cudaError_t {err}")
    LAUNCHES[KERNEL] += 1
    return out


def grouped_attention(q, k, v, bias):
    """(G, Lq, hd) attention of each group's queries over its keys: the
    plain version for CPU tensors, the kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return grouped_attention_plain(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return grouped_attention_kernel(q, k, v, bias)


class GroupedAttentionFused(torch.autograd.Function):
    """Kernel forward, recompute backward through the plain version
    (`grouped_attention_fused`: Pallas forward, `jax.vjp` of
    `grouped_attention_xla` backward). Gradients for q, k, v and bias."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        return grouped_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                 bias.contiguous())

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = grouped_attention_plain(*leaves)
            grads = torch.autograd.grad(out, leaves, g)
        return tuple(gr if need else None for gr, need in zip(grads, ctx.needs_input_grad))


def grouped_attention_fused(q, k, v, bias):
    return GroupedAttentionFused.apply(q, k, v, bias)
