"""The fused local-similarity forward: CUDA kernel wrapper and its plain
PyTorch version (counterpart of demovlp_tpu/ops/pallas_xattn.py's forward:
`_fa_sim_kernel`, `_direction_sim`, `xattn_score_pallas`).

`direction_sim` dispatches on the tensor's device: a CPU tensor goes to
`direction_sim_plain`, a CUDA tensor to the kernel in
csrc/xattn_sim_fwd.cu (built at first use), and anything else raises.
There is no fallback from the kernel to the plain version.

Kernel semantics, which the plain version follows exactly and which differ
from ops/xattn.py only on degenerate rows:
  * softmax exp(lam * a) / sum with no max pass: |a| <= 1 after the l2norm
    over Lq, and a fully masked context row gives p = 0 (not uniform);
  * focal "equal" thresholds with Ls (every position, masked ones
    included) and renormalises to p = 0 when nothing passes;
  * the cosine is against the raw query, num / max(|w| |q|, eps), and the
    mean divides by Lq.
"""
from __future__ import annotations

import ctypes

import torch

from demovlp_tpu_torch.ops import cuda_build

_EPS = 1e-8
KERNEL = "xattn_sim_fwd"
_BLOCK = 64  # items a side in one block pair of the plain version

#: launcher calls since the last reset (compare launches are counted too;
#: callers reset it around the run they want to read). One count is one
#: direction: l2norm_rows_kernel over the context rows and over the query
#: rows, then xattn_sim_fwd_kernel, all three on the current stream.
LAUNCHES = {KERNEL: 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _block_plain(ctx, qry, cmask, lam: float, focal_equal: bool):
    ls = ctx.shape[1]
    lq = qry.shape[1]
    q_norm = torch.sqrt(torch.sum(qry * qry, -1))  # (bq, lq)
    qn = qry / (q_norm[..., None] + _EPS)
    cn = ctx / (torch.sqrt(torch.sum(ctx * ctx, -1, keepdim=True)) + _EPS)
    a = torch.einsum("qld,csd->cqls", qn, cn)
    a = torch.where(a >= 0, a, 0.1 * a)
    sq = torch.sum(a * a, dim=2, keepdim=True)
    a = a / (torch.sqrt(sq) + _EPS) + cmask[:, None, None, :]
    e = torch.exp(a * lam)
    s = torch.sum(e, -1, keepdim=True)
    p = torch.where(s > 0, e / torch.where(s > 0, s, 1.0), 0.0)
    if focal_equal:
        h = (p * ls - torch.sum(p, -1, keepdim=True)) > 0
        p = torch.where(h, p, 0.0)
        s = torch.sum(p, -1, keepdim=True)
        p = torch.where(s > 0, p / torch.where(s > 0, s, 1.0), 0.0)
    w = torch.einsum("cqls,csd->cqld", p, cn)
    num = torch.sum(w * qry[None], -1)
    den = torch.sqrt(torch.sum(w * w, -1)) * q_norm[None]
    cos = num / torch.clamp(den, min=_EPS)
    return torch.sum(cos, -1) / lq  # (bc, bq)


def direction_sim_plain(context, query, ctx_mask, lam: float = 20.0,
                        focal_equal: bool = False):
    """Plain PyTorch version of the kernel: sim (Bc, Bq) f32, materialising
    the (64, 64, Lq, Ls) attention tensor one block pair at a time.
    On the card, run it with TF32 off (device.resolve_device does)."""
    context = context.float()
    query = query.float()
    ctx_mask = ctx_mask.float()
    bc, bq = context.shape[0], query.shape[0]
    out = torch.empty((bc, bq), dtype=torch.float32, device=context.device)
    for c0 in range(0, bc, _BLOCK):
        for q0 in range(0, bq, _BLOCK):
            out[c0:c0 + _BLOCK, q0:q0 + _BLOCK] = _block_plain(
                context[c0:c0 + _BLOCK], query[q0:q0 + _BLOCK],
                ctx_mask[c0:c0 + _BLOCK], float(lam), focal_equal,
            )
    return out


def _library() -> ctypes.CDLL:
    lib = cuda_build.load(KERNEL)
    fn = lib.xattn_sim_fwd
    if fn.argtypes is None:
        # pointers and the stream as c_void_p: a bare Python int would be
        # passed as a 32-bit int and cut the pointer
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def _launch(context, query, ctx_mask, lam: float, focal_equal: bool):
    for name, t in (("context", context), ("query", query), ("ctx_mask", ctx_mask)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != context.device:
            raise ValueError(f"{name} is on {t.device}, context on {context.device}")
    if context.dim() != 3 or query.dim() != 3 or ctx_mask.dim() != 2:
        raise ValueError("expected context (Bc,Ls,D), query (Bq,Lq,D), mask (Bc,Ls)")
    bc, ls, d = context.shape
    bq, lq, dq = query.shape
    if dq != d or tuple(ctx_mask.shape) != (bc, ls):
        raise ValueError(
            f"shape mismatch: context {tuple(context.shape)}, query "
            f"{tuple(query.shape)}, ctx_mask {tuple(ctx_mask.shape)}"
        )
    if min(ls, lq, d) < 1 or d % 4:
        raise ValueError(f"Ls, Lq and D must be positive and D a multiple of 4: {ls, lq, d}")
    if bc * bq >= 2**31:
        raise ValueError(f"{bc}*{bq} blocks exceed the grid; chunk the gallery")
    out = torch.empty((bc, bq), dtype=torch.float32, device=context.device)
    if bc == 0 or bq == 0:
        return out
    lib = _library()
    # scratch: the normalised rows and the query norms, written by the
    # launcher's row-norm kernel before the main kernel reads them
    cn = torch.empty_like(context)
    qn = torch.empty_like(query)
    q_norm = torch.empty((bq, lq), dtype=torch.float32, device=query.device)
    with torch.cuda.device(context.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.xattn_sim_fwd(
            context.data_ptr(), query.data_ptr(), ctx_mask.data_ptr(),
            out.data_ptr(), cn.data_ptr(), qn.data_ptr(), q_norm.data_ptr(),
            bc, bq, ls, lq, d, float(lam), int(focal_equal), stream,
        )
    if err != 0:
        # the launcher sizes shared memory itself; cudaErrorInvalidValue (1)
        # there usually means the (Lq x Ls) score tile does not fit a block
        raise RuntimeError(f"xattn_sim_fwd launch failed (Lq={lq}, Ls={ls}): "
                           f"cudaError_t {err}")
    LAUNCHES[KERNEL] += 1
    return out


def direction_sim(context, query, ctx_mask, lam: float = 20.0,
                  focal_equal: bool = False):
    """sim (Bc, Bq) f32 for one direction: query items attend over context
    items. context (Bc, Ls, D), query (Bq, Lq, D), additive ctx_mask (Bc, Ls)."""
    if context.device.type == "cpu":
        return direction_sim_plain(context, query, ctx_mask, lam, focal_equal)
    if context.device.type != "cuda":
        raise ValueError(f"no kernel for device {context.device}")
    return _launch(context, query, ctx_mask, lam, focal_equal)


def xattn_score_kernel(images, captions, img_mask, cap_mask,
                       lambda_softmax: float = 20.0, focal_type: str = "prob"):
    """(n_images, n_captions) local sims = t2i.T + i2t, both directions
    through `direction_sim`."""
    focal = focal_type == "equal"
    i2t = direction_sim(images, captions, img_mask, lambda_softmax, focal)
    t2i = direction_sim(captions, images, cap_mask, lambda_softmax, focal)
    return t2i.T + i2t
