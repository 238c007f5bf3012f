"""The fused local similarity, forward and backward: CUDA kernel wrappers,
their plain PyTorch versions and the autograd Function that joins them
(counterpart of demovlp_tpu/ops/pallas_xattn.py: `_fa_sim_kernel`,
`_fa_bwd_dq_kernel`, `_fa_bwd_dc_kernel`, the custom_vjp `_pds_fwd` /
`_pds_bwd`, `_direction_sim`, `xattn_score_pallas`).

`direction_sim` and `direction_sim_bwd` dispatch on the tensor's device: a
CPU tensor goes to the plain version, a CUDA tensor to the kernels in
csrc/xattn_sim_fwd.cu and csrc/xattn_sim_bwd.cu (built at first use), and
anything else raises. There is no fallback from a kernel to a plain version.

Kernel semantics, which the plain versions follow exactly and which differ
from ops/xattn.py only on degenerate rows:
  * softmax exp(lam * a) / sum with no max pass: |a| <= 1 after the l2norm
    over Lq, and a fully masked context row gives p = 0 (not uniform);
  * focal "equal" thresholds with Ls (every position, masked ones
    included) and renormalises to p = 0 when nothing passes;
  * the cosine is against the raw query, num / max(|w| |q|, eps), and the
    mean divides by Lq.

Two modes. f32: every product in f32 (on the card 3xTF32 tensor-core
products, which agree with f32 products to about 3e-7 of the largest sim;
tests/test_torch_tc_numerics.py emulates them). bf16 (the TPU kernel's `mxu_bf16`,
training's local loss with `local_dtype: "bfloat16"`): the inputs are
rounded to bf16 before the row norms (the wrappers take them as f32 tensors
holding bf16 values), every product operand is rounded to bf16 and
accumulated in f32, and the norms, softmax, focal renorm and cosine stay
f32. The gradient that leaves a direction is rounded to bf16, as the TPU
kernel's cotangent takes the primal's bf16 dtype.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from demovlp_tpu_torch.ops import cuda_build

_EPS = 1e-8
#: the values of JAX's `ops.xattn.set_backend` (`ops.xattn_backend`,
#: `eval.xattn_backend`, DEMOVLP_XATTN_BACKEND). The port reads and checks
#: them; its route on the card is these kernels whichever is named.
XATTN_BACKENDS = ("xla", "pallas", "auto")
KERNEL = "xattn_sim_fwd"  # forward, f32 mode
KERNEL_BF16 = "xattn_sim_fwd_bf16"  # forward, bf16 mode (same source)
KERNEL_DQ = "xattn_sim_bwd_dq"
KERNEL_DC = "xattn_sim_bwd_dc"
_BWD_SOURCE = "xattn_sim_bwd"
_BLOCK = 64  # items a side in one block pair of the plain versions

#: launcher calls since the last reset (compare launches are counted too;
#: callers reset it around the run they want to read). A forward count is
#: one direction: l2norm_rows_kernel over the context rows and over the
#: query rows, then xattn_sim_fwd_tf32_kernel (f32 mode); or in bf16 mode
#: l2norm_rows_bf16_kernel twice, then xattn_sim_fwd_bf16_kernel on an
#: (items, S) grid (S from the launcher). A backward count is the same two
#: row-norm launches, then xattn_sim_bwd_dq_kernel and
#: xattn_sim_bwd_dq_reduce_kernel, or xattn_sim_bwd_dc_kernel and
#: xattn_sim_bwd_dc_reduce_kernel.
LAUNCHES = {KERNEL: 0, KERNEL_BF16: 0, KERNEL_DQ: 0, KERNEL_DC: 0}
#: the same counts split by shape: (name, Ls, Lq) -> launches
SHAPE_LAUNCHES: dict = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    SHAPE_LAUNCHES.clear()


def _count(name: str, ls: int, lq: int) -> None:
    LAUNCHES[name] += 1
    SHAPE_LAUNCHES[(name, ls, lq)] = SHAPE_LAUNCHES.get((name, ls, lq), 0) + 1


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest even) and held in f32."""
    return x.to(torch.bfloat16).float()


def _normalise(x):
    norm = torch.sqrt(torch.sum(x * x, -1, keepdim=True))
    return x / (norm + _EPS), norm[..., 0]


def _forward_block(ctx, qry, cmask, lam: float, focal_equal: bool, bf16: bool):
    """The forward of one block pair with everything the backward needs."""
    op = round_bf16 if bf16 else (lambda t: t)
    ls, lq = ctx.shape[1], qry.shape[1]
    qn, q_norm = _normalise(qry)  # (bq, lq, d), (bq, lq)
    cn, _ = _normalise(ctx)
    a0 = torch.einsum("qld,csd->cqls", op(qn), op(cn))
    a1 = torch.where(a0 >= 0, a0, 0.1 * a0)
    sq = torch.sum(a1 * a1, dim=2, keepdim=True)
    r = torch.sqrt(sq) + _EPS
    a2 = a1 / r
    e = torch.exp((a2 + cmask[:, None, None, :]) * lam)
    s1 = torch.sum(e, -1, keepdim=True)
    p = torch.where(s1 > 0, e / torch.where(s1 > 0, s1, 1.0), 0.0)
    h = fsum = None
    ph = p
    if focal_equal:
        h = (p * ls - torch.sum(p, -1, keepdim=True)) > 0
        pt = torch.where(h, p, 0.0)
        fsum = torch.sum(pt, -1, keepdim=True)
        ph = torch.where(fsum > 0, pt / torch.where(fsum > 0, fsum, 1.0), 0.0)
    w = torch.einsum("cqls,csd->cqld", op(ph), op(cn))
    num = torch.sum(w * qry[None], -1)  # (bc, bq, lq)
    wn = torch.sqrt(torch.sum(w * w, -1))
    den_raw = wn * q_norm[None]
    cos = num / torch.clamp(den_raw, min=_EPS)
    sim = torch.sum(cos, -1) / lq  # (bc, bq)
    return sim, dict(op=op, qn=qn, q_norm=q_norm, cn=cn, a0=a0, a1=a1, sq=sq, r=r,
                     a2=a2, p=p, h=h, fsum=fsum, ph=ph, w=w, num=num, wn=wn,
                     den_raw=den_raw)


def _block_plain(ctx, qry, cmask, lam: float, focal_equal: bool, bf16: bool = False):
    """sim (bc, bq) of one block pair."""
    return _forward_block(ctx, qry, cmask, lam, focal_equal, bf16)[0]


def direction_sim_plain(context, query, ctx_mask, lam: float = 20.0,
                        focal_equal: bool = False, mxu_bf16: bool = False):
    """Plain PyTorch version of the forward kernel: sim (Bc, Bq) f32,
    materialising the (64, 64, Lq, Ls) attention tensor one block pair at a
    time. In bf16 mode the inputs must already hold bf16 values.
    On the card, run it with TF32 off (device.resolve_device does)."""
    context, query, ctx_mask = context.float(), query.float(), ctx_mask.float()
    bc, bq = context.shape[0], query.shape[0]
    out = torch.empty((bc, bq), dtype=torch.float32, device=context.device)
    for c0 in range(0, bc, _BLOCK):
        for q0 in range(0, bq, _BLOCK):
            out[c0:c0 + _BLOCK, q0:q0 + _BLOCK] = _block_plain(
                context[c0:c0 + _BLOCK], query[q0:q0 + _BLOCK],
                ctx_mask[c0:c0 + _BLOCK], float(lam), focal_equal, mxu_bf16,
            )
    return out


def backward_da1(ctx, qry, cmask, g, lam: float, focal_equal: bool, bf16: bool):
    """One block pair's backward as far as da1 (bc, bq, lq, ls), the
    cotangent of the leaky-ReLU's output: (da1, the forward's intermediates,
    dw, dq_direct). Any float dtype."""
    lq = qry.shape[1]
    _, f = _forward_block(ctx, qry, cmask, lam, focal_equal, bf16)
    op, q_norm, w, num, wn, den_raw = (f[k] for k in ("op", "q_norm", "w", "num", "wn",
                                                      "den_raw"))
    qb = q_norm[None]  # (1, bq, lq)
    den = torch.clamp(den_raw, min=_EPS)
    dcos = g[:, :, None] / lq
    dnum = dcos / den
    dden = torch.where(den_raw >= _EPS, -dcos * num / (den * den), 0.0)
    cw = torch.where(wn > 0, dden * qb / torch.where(wn > 0, wn, 1.0), 0.0)
    cq = torch.where(qb > 0, dden * wn / torch.where(qb > 0, qb, 1.0), 0.0)
    dw = dnum[..., None] * qry[None] + cw[..., None] * w
    dq_direct = torch.sum(dnum[..., None] * w + cq[..., None] * qry[None], 0)
    dph = torch.einsum("cqld,csd->cqls", op(dw), op(f["cn"]))
    p, ph = f["p"], f["ph"]
    dp = dph
    if focal_equal:
        fsum = f["fsum"]
        dot_ps = torch.sum(dph * ph, -1, keepdim=True)
        dpt = torch.where(fsum > 0, (dph - dot_ps) / torch.where(fsum > 0, fsum, 1.0), 0.0)
        dp = torch.where(f["h"], dpt, 0.0)
    da3 = lam * p * (dp - torch.sum(dp * p, -1, keepdim=True))
    # l2norm over Lq: the column sums first, divisions in sequence
    t = torch.sum(da3 * f["a1"], dim=2, keepdim=True)
    sq, r = f["sq"], f["r"]
    sq_pos = sq > 0
    sqrt_sq = torch.where(sq_pos, r - _EPS, 1.0)
    ratio = torch.where(sq_pos, t / r / sqrt_sq, 0.0)
    da1 = da3 / r - ratio * f["a2"]
    return da1, f, dw, dq_direct


def _backward_block(ctx, qry, cmask, g, lam: float, focal_equal: bool, bf16: bool):
    """One block pair's analytic backward (pallas_xattn.py `_fa_bwd_tile`):
    (dq_direct (bq, lq, d), dqn (bq, lq, d), dcn (bc, ls, d)), each summed
    over the block's other side. The qn and cn backwards are applied once
    to the totals (both are linear in dqn / dcn)."""
    da1, f, dw, dq_direct = backward_da1(ctx, qry, cmask, g, lam, focal_equal, bf16)
    op, ph = f["op"], f["ph"]
    da0 = torch.where(f["a0"] >= 0, da1, 0.1 * da1)
    dqn = torch.einsum("cqls,csd->qld", op(da0), op(f["cn"]))
    dcn = (torch.einsum("cqls,cqld->csd", op(ph), op(dw))
           + torch.einsum("cqls,qld->csd", op(da0), op(f["qn"])))
    return dq_direct, dqn, dcn


def _unit_backward(dxn, x):
    """Backward of xn = x / (|x| + eps) (pallas_xattn.py `_cn_to_c_grad`)."""
    norm = torch.sqrt(torch.sum(x * x, -1, keepdim=True))
    den = norm + _EPS
    dot = torch.sum(dxn * x, -1, keepdim=True)
    coef = torch.where(norm > 0, dot / torch.where(norm > 0, norm, 1.0) / (den * den), 0.0)
    return dxn / den - coef * x


def direction_sim_bwd_plain(context, query, ctx_mask, g, lam: float = 20.0,
                            focal_equal: bool = False, mxu_bf16: bool = False):
    """Plain PyTorch version of the backward kernels: (d_context (Bc, Ls, D),
    d_query (Bq, Lq, D)) f32 for the cotangent g (Bc, Bq), 64 x 64 block
    pairs at a time, with the kernels' guards. In bf16 mode the inputs must
    already hold bf16 values; the result is not rounded (the Function does)."""
    context, query, ctx_mask, g = context.float(), query.float(), ctx_mask.float(), g.float()
    bc, bq = context.shape[0], query.shape[0]
    dq_direct = torch.zeros_like(query)
    dqn = torch.zeros_like(query)
    dcn = torch.zeros_like(context)
    for c0 in range(0, bc, _BLOCK):
        cs = slice(c0, c0 + _BLOCK)
        for q0 in range(0, bq, _BLOCK):
            qs = slice(q0, q0 + _BLOCK)
            a, b, c = _backward_block(context[cs], query[qs], ctx_mask[cs], g[cs, qs],
                                      float(lam), focal_equal, mxu_bf16)
            dq_direct[qs] += a
            dqn[qs] += b
            dcn[cs] += c
    return _unit_backward(dcn, context), dq_direct + _unit_backward(dqn, query)


def _check(context, query, ctx_mask, g=None):
    named = [("context", context), ("query", query), ("ctx_mask", ctx_mask)]
    if g is not None:
        named.append(("g", g))
    for name, t in named:
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
    if g is not None and tuple(g.shape) != (bc, bq):
        raise ValueError(f"g must be ({bc}, {bq}), got {tuple(g.shape)}")
    if min(ls, lq, d) < 1 or d % 4:
        raise ValueError(f"Ls, Lq and D must be positive and D a multiple of 4: {ls, lq, d}")
    if bc * bq >= 2**31:
        raise ValueError(f"{bc}*{bq} blocks exceed the grid; chunk the gallery")


_ARGTYPES = {
    # pointers and the stream as c_void_p: a bare Python int would be
    # passed as a 32-bit int and cut the pointer
    "xattn_sim_fwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "xattn_sim_bwd_dq": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "xattn_sim_bwd_workspace": [ctypes.c_int] * 4,
    "xattn_sim_bwd_blocks_per_sm": [ctypes.c_int] * 5,
    "xattn_sim_fwd_bf16_splits": [ctypes.c_int] * 5,
    "xattn_l2norm_rows_bf16": [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                                       ctypes.c_void_p],
}
_ARGTYPES["xattn_sim_bwd_dc"] = _ARGTYPES["xattn_sim_bwd_dq"]
_RESTYPES = {"xattn_sim_bwd_workspace": ctypes.c_longlong}


def _function(source: str, name: str):
    fn = getattr(cuda_build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return fn


def _scratch(context, query):
    """The normalised rows and the query norms, written by the launchers'
    row-norm kernel before their main kernel reads them."""
    bq, lq, _ = query.shape
    return (torch.empty_like(context), torch.empty_like(query),
            torch.empty((bq, lq), dtype=torch.float32, device=query.device))


def _launch(context, query, ctx_mask, lam: float, focal_equal: bool, mxu_bf16: bool = False):
    _check(context, query, ctx_mask)
    bc, ls, d = context.shape
    bq, lq, _ = query.shape
    out = torch.empty((bc, bq), dtype=torch.float32, device=context.device)
    if bc == 0 or bq == 0:
        return out
    fn = _function(KERNEL, "xattn_sim_fwd")
    cn, qn, q_norm = _scratch(context, query)
    with torch.cuda.device(context.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(context.data_ptr(), query.data_ptr(), ctx_mask.data_ptr(), out.data_ptr(),
                 cn.data_ptr(), qn.data_ptr(), q_norm.data_ptr(), bc, bq, ls, lq, d,
                 float(lam), int(focal_equal), int(mxu_bf16), stream)
    if err != 0:
        # the launcher sizes shared memory itself; cudaErrorInvalidValue (1)
        # there usually means the (Lq x Ls) score tile does not fit a block
        raise RuntimeError(f"xattn_sim_fwd launch failed (Lq={lq}, Ls={ls}): "
                           f"cudaError_t {err}")
    _count(KERNEL_BF16 if mxu_bf16 else KERNEL, ls, lq)
    return out


def bf16_forward_splits(bc: int, bq: int, ls: int, lq: int, d: int) -> int:
    """S, the blocks that share one held item's partners in the bf16
    forward, as its launcher picks it on the current card for this shape
    (backward_splits' rule over the launcher's occupancy query), or
    -cudaError_t where the shape is refused."""
    return int(_function(KERNEL, "xattn_sim_fwd_bf16_splits")(bc, bq, ls, lq, d))


_MAX_SPLITS = 65535  # the grid's y extent


@functools.lru_cache(maxsize=None)
def backward_splits(items: int, partners: int, slots: int) -> int:
    """S, the number of blocks that share one output item's partners in a
    backward kernel: the smallest S that minimises the pair-steps on the
    busiest slot, ceil(items * S / slots) * ceil(partners / S), where
    `slots` is the number of blocks the card runs at once (SMs x resident
    blocks a SM). S stays within one wave (items * S <= slots; S = 1 where
    the items alone fill the slots), within the partners and within the
    grid's 65535: past one wave the step count can still fall by the last
    wave's imbalance (125 against 128 steps at 128 items and partners on
    132 slots, with S = 128), while every block adds a partial slice to
    write and to reduce."""
    top = max(1, min(partners, _MAX_SPLITS, slots // max(items, 1)))
    # min keeps the first of equal step counts: the smallest S
    return min(range(1, top + 1), key=lambda s: -(-items * s // slots) * -(-partners // s))


_SLOTS = {}  # (device index, name, Ls, Lq, D, bf16) -> blocks the card runs at once


def backward_plan(name: str, context, query, mxu_bf16: bool) -> tuple:
    """(S, slots) for a launch of the d_query (name KERNEL_DQ) or d_context
    (KERNEL_DC) kernel on CUDA tensors: slots = the card's SMs x the blocks
    of this instantiation an SM holds (the launcher's occupancy query)."""
    bc, ls, d = context.shape
    bq, lq, _ = query.shape
    key = (context.device.index, name, ls, lq, d, bool(mxu_bf16))
    if key not in _SLOTS:
        per_sm = int(_function(_BWD_SOURCE, "xattn_sim_bwd_blocks_per_sm")(
            int(name == KERNEL_DC), ls, lq, d, int(mxu_bf16)))
        if per_sm < 1:
            # a negative count is -cudaError_t: cudaErrorInvalidValue (1) where
            # the operands and the pair's vectors exceed shared memory
            raise RuntimeError(f"{name}: no block fits an SM (Lq={lq}, Ls={ls}, D={d}): "
                               f"cudaError_t {max(-per_sm, 0)} from the occupancy query")
        sms = torch.cuda.get_device_properties(context.device).multi_processor_count
        _SLOTS[key] = sms * per_sm
    items, partners = (bq, bc) if name == KERNEL_DQ else (bc, bq)
    slots = _SLOTS[key]
    return backward_splits(items, partners, slots), slots


def _launch_bwd(name: str, context, query, ctx_mask, g, lam: float, focal_equal: bool,
                mxu_bf16: bool):
    """d_query (name KERNEL_DQ) or d_context (KERNEL_DC) from the kernels:
    the main kernel on (items, S) blocks, each over its share of the
    partners, then the reduce kernel over the S partials."""
    _check(context, query, ctx_mask, g)
    bc, ls, d = context.shape
    bq, lq, _ = query.shape
    out = torch.empty_like(query if name == KERNEL_DQ else context)
    if bc == 0 or bq == 0:
        return out.zero_()
    fn = _function(_BWD_SOURCE, name)
    splits, _ = backward_plan(name, context, query, mxu_bf16)
    cn, qn, q_norm = _scratch(context, query)
    part = torch.empty((splits,) + tuple(out.shape), dtype=torch.float32, device=out.device)
    part_dqn = torch.empty_like(part) if name == KERNEL_DQ else None  # d_query's dqn
    # where a pair's tiles do not fit one block's shared memory (f = 8), each
    # block keeps them in its own slice of this workspace (size from the
    # launcher's own sizing)
    per_block = int(_function(_BWD_SOURCE, "xattn_sim_bwd_workspace")(ls, lq, d, int(mxu_bf16)))
    blocks = (bq if name == KERNEL_DQ else bc) * splits
    ws = (torch.empty(blocks * per_block, dtype=torch.float32, device=context.device)
          if per_block else None)
    with torch.cuda.device(context.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(context.data_ptr(), query.data_ptr(), ctx_mask.data_ptr(), g.data_ptr(),
                 out.data_ptr(), cn.data_ptr(), qn.data_ptr(), q_norm.data_ptr(),
                 part.data_ptr(), None if part_dqn is None else part_dqn.data_ptr(),
                 None if ws is None else ws.data_ptr(),
                 bc, bq, ls, lq, d, float(lam), int(focal_equal), int(mxu_bf16), splits, stream)
    if err != 0:
        # cudaErrorInvalidValue (1): the operands and the pair's row and
        # column vectors do not fit one block's shared memory
        raise RuntimeError(f"{name} launch failed (Lq={lq}, Ls={ls}, D={d}, S={splits}): "
                           f"cudaError_t {err}")
    _count(name, ls, lq)
    return out


def check_backend(key: str, value: str) -> str:
    """`value` of the setting `key` when it is one of XATTN_BACKENDS; else
    ValueError naming the key."""
    if value not in XATTN_BACKENDS:
        raise ValueError(f"{key}={value!r}: expected one of {list(XATTN_BACKENDS)}")
    return value


def _device_of(context) -> str:
    if context.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {context.device}")
    return context.device.type


def direction_sim(context, query, ctx_mask, lam: float = 20.0,
                  focal_equal: bool = False, mxu_bf16: bool = False):
    """sim (Bc, Bq) f32 for one direction: query items attend over context
    items. context (Bc, Ls, D), query (Bq, Lq, D), additive ctx_mask (Bc, Ls);
    in bf16 mode the inputs must already hold bf16 values (f32 tensors)."""
    if _device_of(context) == "cpu":
        return direction_sim_plain(context, query, ctx_mask, lam, focal_equal, mxu_bf16)
    return _launch(context, query, ctx_mask, lam, focal_equal, mxu_bf16)


def direction_sim_bwd(context, query, ctx_mask, g, lam: float = 20.0,
                      focal_equal: bool = False, mxu_bf16: bool = False):
    """(d_context, d_query) f32 of `direction_sim` for the cotangent g."""
    if _device_of(context) == "cpu":
        return direction_sim_bwd_plain(context, query, ctx_mask, g, lam, focal_equal, mxu_bf16)
    args = (context, query, ctx_mask, g, lam, focal_equal, mxu_bf16)
    return _launch_bwd(KERNEL_DC, *args), _launch_bwd(KERNEL_DQ, *args)


class DirectionSim(torch.autograd.Function):
    """One direction with the analytic backward; the mask's cotangent is
    None (masks are data)."""

    @staticmethod
    def forward(ctx, context, query, ctx_mask, lam, focal_equal, mxu_bf16):
        ctx.save_for_backward(context, query, ctx_mask)
        ctx.args = (lam, focal_equal, mxu_bf16)
        return direction_sim(context, query, ctx_mask, lam, focal_equal, mxu_bf16)

    @staticmethod
    def backward(ctx, g):
        context, query, ctx_mask = ctx.saved_tensors
        dc, dq = direction_sim_bwd(context, query, ctx_mask, g.float().contiguous(),
                                   *ctx.args)
        return dc, dq, None, None, None, None


def differentiable_direction_sim(context, query, ctx_mask, lam: float = 20.0,
                                 focal_equal: bool = False, mxu_bf16: bool = False):
    """`direction_sim` with gradients to context and query. In bf16 mode the
    inputs are rounded to bf16 here, by casts that autograd differentiates:
    the f32 gradient from the backward kernels is rounded to bf16 on its
    way back and upcast, once for each direction."""
    context, query = context.float(), query.float()
    if mxu_bf16:
        context, query = round_bf16(context), round_bf16(query)
    return DirectionSim.apply(context.contiguous(), query.contiguous(),
                              ctx_mask.float().contiguous(), float(lam),
                              bool(focal_equal), bool(mxu_bf16))


def xattn_score_kernel(images, captions, img_mask, cap_mask,
                       lambda_softmax: float = 20.0, focal_type: str = "prob",
                       compute_dtype: torch.dtype | None = None):
    """(n_images, n_captions) local sims = t2i.T + i2t, f32, differentiable
    with respect to images and captions. compute_dtype=torch.bfloat16
    selects the bf16 mode."""
    focal = focal_type == "equal"
    bf16 = compute_dtype == torch.bfloat16
    i2t = differentiable_direction_sim(images, captions, img_mask, lambda_softmax, focal, bf16)
    t2i = differentiable_direction_sim(captions, images, cap_mask, lambda_softmax, focal, bf16)
    return t2i.T + i2t
