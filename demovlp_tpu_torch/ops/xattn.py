"""Cross-modal (region <-> word) attention similarity, plain PyTorch forward
(counterpart of demovlp_tpu/ops/xattn.py, the Gram form `_xattn_score_xla`).

Shapes:
  query    (Bq, Lq, D)   context (Bc, Ls, D)
  *_mask   additive masks: 0 for valid, -100 for pad (ops/masking.py)

Reference quirks kept exactly:
  * the query-side additive mask is a softmax no-op (constant per row) but
    is still added before the softmax, as the reference does;
  * the per-position cosine is averaged over ALL Lq query positions,
    padded ones included;
  * `xattn_score(images, captions, ...)` returns t2i.T + i2t, shape
    (n_images, n_captions), in f32.

This is the model-side form (softmax with a max pass, 0/0 guard falling
back to `attn`). The serving kernel's semantics, which differ only on
fully-masked rows, live in ops/xattn_kernel.py.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from demovlp_tpu_torch.ops.masking import l2norm


def focal_equal(attn: torch.Tensor) -> torch.Tensor:
    """Indicator 1[attn > mean(attn)] over the last axis."""
    source_l = attn.shape[-1]
    func_f = attn * source_l - torch.sum(attn, dim=-1, keepdim=True)
    return (func_f > 0).to(attn.dtype)


def _re_attention(query_n, context_n, query_mask, context_mask,
                  lambda_softmax: float, focal_type: str):
    """Focal re-attention over context positions for already l2-normalized
    (Bq, Lq, D) query and (Bc, Ls, D) context. Returns (re_attn, attn0),
    both (Bc, Bq, Lq, Ls); attn0 is the raw normalized dot product."""
    attn0 = torch.einsum("csd,qld->cqls", context_n, query_n)
    attn = F.leaky_relu(attn0, negative_slope=0.1)
    attn = l2norm(attn, dim=2)  # over the query axis
    query_mask = query_mask.to(attn.dtype)
    context_mask = context_mask.to(attn.dtype)
    attn = attn + query_mask[None, :, :, None] + context_mask[:, None, None, :]
    attn = torch.softmax(attn * lambda_softmax, dim=-1)
    func_h = focal_equal(attn) if focal_type == "equal" else 1.0
    tmp_attn = func_h * attn
    attn_sum = torch.sum(tmp_attn, dim=-1, keepdim=True)
    # 0/0 guard by where-select: an exactly uniform row zeroes func_h; the
    # limit of the renormalisation there is attn itself
    ok = attn_sum > 0
    re_attn = torch.where(ok, tmp_attn, attn) / torch.where(
        ok, attn_sum, torch.sum(attn, dim=-1, keepdim=True)
    )
    return re_attn, attn0


def _sim_one_direction_gram(query, context, query_mask, context_mask,
                            lambda_softmax: float, focal_type: str,
                            eps: float = 1e-8) -> torch.Tensor:
    """mean_l cos(query_ql, sum_s re_attn * cn_s) via the Gram identity
    |w|^2 = re_attn^T G re_attn, G = cn cn^T. Returns (Bc, Bq) f32."""
    qn = l2norm(query, dim=-1)
    cn = l2norm(context, dim=-1)
    re_attn, attn0 = _re_attention(
        qn, cn, query_mask, context_mask, lambda_softmax, focal_type
    )
    bc, bq, lq, ls = re_attn.shape
    re2 = re_attn.reshape(bc, bq * lq, ls)
    a02 = attn0.reshape(bc, bq * lq, ls)
    s = torch.einsum("cns,cns->cn", re2.float(), a02.float())
    gram = torch.einsum("csd,ctd->cst", cn.float(), cn.float())
    h = torch.einsum("cns,cst->cnt", re2, gram.to(re2.dtype))
    w2sq = torch.einsum("cnt,cnt->cn", h.float(), re2.float())
    w1 = torch.linalg.norm(query.float(), dim=-1)  # (Bq, Lq)
    w12 = (w1.reshape(1, bq * lq) + eps) * s
    w2 = torch.sqrt(torch.clamp(w2sq, min=0.0))
    cos = w12 / torch.clamp(w1.reshape(1, bq * lq) * w2, min=eps)
    return torch.mean(cos.reshape(bc, bq, lq), dim=-1)


def xattn_score(images, captions, img_mask, cap_mask,
                lambda_softmax: float = 20.0, focal_type: str = "prob") -> torch.Tensor:
    """Symmetric local similarity (n_images, n_captions), f32.

    images (Ni, R, D), captions (Nc, W, D), additive masks (Ni, R) and
    (Nc, W). The bf16 `compute_dtype` pipeline waits for the training slice."""
    # i2t: caption words attend over image regions -> (n_img, n_cap)
    i2t = _sim_one_direction_gram(
        captions, images, cap_mask, img_mask, lambda_softmax, focal_type
    )
    # t2i: image regions attend over caption words -> (n_cap, n_img)
    t2i = _sim_one_direction_gram(
        images, captions, img_mask, cap_mask, lambda_softmax, focal_type
    )
    return (t2i.T + i2t).float()
