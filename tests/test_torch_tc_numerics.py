"""The numerics of the port's tensor-core kernels, pinned on the CPU by
emulating them in torch.

* The f32 local-similarity forward (csrc/xattn_sim_fwd.cu,
  xattn_sim_fwd_tf32_kernel) takes each product as 3xTF32: every f32
  operand x is split into hi = tf32(x) and lo = tf32(x - hi), rounded as
  cvt.rna.tf32.f32 rounds (to nearest, ties away from zero), and
  a b = a_lo b_hi + a_hi b_lo + a_hi b_hi with f32 sums. Its row pass
  (l2norm_rows_tf32_kernel) splits each normalised row once; the kernel's
  order is per 8-deep k step, the three passes in that order. Here the plain
  version `direction_sim_plain` runs with its two products emulated that
  way (torch.einsum patched for the test), and must stay within 1e-6 of the
  f32 plain version's largest sim at the serving and training shapes,
  both directions and both focal types. A single TF32 pass must miss that
  gate by more than 1e-5 somewhere: the control that shows the gate tells
  the two apart.
* The bf16-mode local-similarity backward (csrc/xattn_sim_bwd.cu) takes its
  products on bf16 `mma.sync` tiles: bf16 operands, rounded where the plain
  version rounds them, with f32 sums in the tiles' order. A product of two
  bf16 values is exact, so against the plain version's f32 products the
  only freedom is the order of the sums. Here every product of the plain
  bf16-mode backward is taken again in float64 on its own (bf16-valued)
  operands and must agree within 1e-6 of its largest entry; the whole
  backward with float64 products (later operands then rounded from
  slightly other values) is held to the card's bf16 tolerance (chip_smoke
  TOL_TRAIN["bf16"], with its allowance for operands whose rounding flips).
* The bf16-mode local-similarity forward (csrc/xattn_sim_fwd.cu,
  xattn_sim_fwd_bf16_kernel) takes qn and cn as bf16 rows rounded to
  nearest even from the f32 normalised rows, both products on bf16 `mma`
  tiles (exact bf16 products, each 16-deep k step added to the f32
  accumulator), P rounded to bf16, and num and |w|^2 summed per 32-column
  chunk, the chunks in order. Emulated here and held within the card's bf16
  tolerance (chip_smoke TOL_TRAIN["bf16"] with its flip allowance) of the
  plain bf16 version and of JAX's interpret-mode Pallas kernel in bf16.
* The bf16 grouped attention on `mma` tiles (csrc/grouped_attention.cu,
  grouped_attention_mma_kernel) keeps the JAX op's rounding sites with two
  passes over key chunks of 16 (padded keys out of the max and the sum):
  pass 1 the row max and the sum of exp(x - max), merged chunk by chunk;
  pass 2 the normalised probability rounded to bf16, times V, the result
  rounded to bf16. Emulated here and held within 2^-7 of the result's
  largest magnitude (two bf16 ulps at that scale) against
  `grouped_attention_plain` and JAX's `grouped_attention_xla`.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from demovlp_tpu_torch.ops import attention_kernel as ak
from demovlp_tpu_torch.ops import xattn_kernel as xk

_EINSUM = torch.einsum
SIM_GATE = 1e-6  # 3xTF32 against f32, relative to the largest sim
F32_GATE = 1e-5  # the f32 gate the card holds the kernel to (chip_smoke TOL_TRAIN)
BF16_REL = 2.0 ** -7


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32 as cvt.rna.tf32.f32 rounds it: add half a
    unit of the 13 dropped bits to the bit pattern's magnitude, clear them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + (1 << 12)) & -(1 << 13)).view(torch.float32)


def split_tf32(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def einsum_3xtf32(eq, a, b):
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return _EINSUM(eq, al, bh) + _EINSUM(eq, ah, bl) + _EINSUM(eq, ah, bh)


def einsum_1xtf32(eq, a, b):
    return _EINSUM(eq, tf32_rna(a), tf32_rna(b))


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 1e3, 1e30])
def test_tf32_split_reconstructs_f32(scale):
    x = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(np.float32)) * scale
    hi, lo = split_tf32(x)
    for t in (hi, lo):  # TF32: the low 13 mantissa bits are zero
        assert int((t.view(torch.int32) & ((1 << 13) - 1)).abs().max()) == 0
    assert float(((x - hi).abs() / x.abs()).max()) <= 2.0 ** -11  # half a TF32 ulp
    assert float(((x - (hi + lo)).abs() / x.abs()).max()) <= 2.0 ** -21


def test_tf32_rounds_to_nearest_with_ties_away_from_zero():
    u = 2.0 ** -10  # a TF32 ulp at 1
    x = torch.tensor([1 + u / 2, -(1 + u / 2), 1 + u / 2 - 2.0 ** -23, 1 + 1.5 * u, 3.0, 0.0],
                     dtype=torch.float32)
    want = torch.tensor([1 + u, -(1 + u), 1.0, 1 + 2 * u, 3.0, 0.0], dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)


@pytest.mark.parametrize("d", [20, 36, 256])
def test_3xtf32_product_matches_float64(d):
    """One product at a depth D that is not a multiple of 8 (20, 36) and at
    the serving depth: 3xTF32 lands within a few f32 roundings of the exact
    product, a single TF32 pass about 1e3 times further."""
    rng = np.random.RandomState(d)
    a = torch.from_numpy(rng.randn(99, d).astype(np.float32))
    b = torch.from_numpy(rng.randn(240, d).astype(np.float32))
    exact = _EINSUM("ld,sd->ls", a.double(), b.double())
    scale = float(exact.abs().max())
    err3 = float((einsum_3xtf32("ld,sd->ls", a, b).double() - exact).abs().max()) / scale
    err1 = float((einsum_1xtf32("ld,sd->ls", a, b).double() - exact).abs().max()) / scale
    assert err3 <= 1e-6, err3
    assert err1 >= 100 * err3, (err1, err3)


def _items(n, length, d, seed):
    """As chip_smoke's serving inputs: ~30% of positions masked (-100),
    item 1 masked throughout."""
    rng = np.random.RandomState(seed)
    feats = torch.from_numpy(rng.randn(n, length, d).astype(np.float32))
    mask = torch.from_numpy(((rng.rand(n, length) > 0.3).astype(np.float32) - 1.0) * 100.0)
    mask[1] = -100.0
    return feats, mask


def _sims(ls, lq, focal, seed, product=None, monkeypatch=None):
    ctx, cmask = _items(3, ls, 256, seed)
    qry, _ = _items(3, lq, 256, seed + 100)
    if product is not None:
        monkeypatch.setattr(torch, "einsum", product)
    try:
        return xk.direction_sim_plain(ctx, qry, cmask, 20.0, focal == "equal")
    finally:
        if product is not None:
            monkeypatch.undo()


# (Ls, Lq): serving and the f = 8 fine-tune, i2t (240 regions, 99 words)
# and t2i; the f = 1 training shapes (30 regions)
_SIM_SHAPES = [(240, 99), (99, 240), (30, 99), (99, 30)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("focal", ["prob", "equal"])
@pytest.mark.parametrize("ls,lq", _SIM_SHAPES, ids=["i2t", "t2i", "i2t-f1", "t2i-f1"])
def test_3xtf32_sims_match_f32(ls, lq, focal, seed, monkeypatch):
    want = _sims(ls, lq, focal, seed)
    got = _sims(ls, lq, focal, seed, einsum_3xtf32, monkeypatch)
    assert torch.isfinite(got).all()
    assert float(got[1].abs().max()) == 0.0  # a fully masked context item
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err <= SIM_GATE, err


def test_1xtf32_sims_miss_the_f32_gate(monkeypatch):
    """The control: one TF32 pass moves some sim by more than the 1e-5 gate
    that 3xTF32 holds by a wide margin."""
    errs = []
    for ls, lq in _SIM_SHAPES[:2]:
        for focal in ("prob", "equal"):
            want = _sims(ls, lq, focal, 0)
            got = _sims(ls, lq, focal, 0, einsum_1xtf32, monkeypatch)
            errs.append(float((got - want).abs().max()) / float(want.abs().max()))
    assert max(errs) > F32_GATE, errs


def _normalised_rows(n, length, d, seed):
    """Rows as the f32 row pass writes them before its split: x / (|x| + eps)."""
    x = torch.from_numpy(np.random.RandomState(seed).randn(n * length, d).astype(np.float32))
    return x / (x.norm(dim=-1, keepdim=True) + 1e-8)


def _kernel_order_3xtf32(a_split, b_split, step=8):
    """a (M, K) b (N, K)^T as the f32 kernel accumulates it, from hi and lo
    parts given as (hi, lo) pairs: for each 8-deep k step, a_lo b_hi, then
    a_hi b_lo, then a_hi b_hi added to an f32 accumulator (each step's
    products summed exactly, in float64, and rounded once)."""
    (ah, al), (bh, bl) = a_split, b_split
    acc = torch.zeros(ah.shape[0], bh.shape[0])
    for k in range(0, ah.shape[1], step):
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = acc + _EINSUM("mk,nk->mn", x[:, k:k + step].double(),
                                y[:, k:k + step].double()).float()
    return acc


def _split_per_fragment(x, step=8):
    """The split the kernel took before its row pass: each 8-deep chunk of
    the f32 rows split into hi and lo as its fragments were read."""
    parts = [split_tf32(x[:, k:k + step].contiguous()) for k in range(0, x.shape[1], step)]
    return torch.cat([h for h, _ in parts], 1), torch.cat([lo for _, lo in parts], 1)


@pytest.mark.parametrize("d", [20, 36, 256])
def test_split_once_rows_give_the_per_fragment_products(d):
    """The row pass splits each normalised row once (qn as product 1's A,
    cn as its B and, transposed, as product 2's B); the kernel before it
    split the same f32 values chunk by chunk as it read them. The parts are
    the same bits, so every product, in the kernel's pass order, is too."""
    qn = _normalised_rows(3, 99, d, seed=d)
    cn = _normalised_rows(2, 240, d, seed=d + 1)
    once_q, once_c = split_tf32(qn), split_tf32(cn)
    for once, x in ((once_q, qn), (once_c, cn)):
        for a, b in zip(once, _split_per_fragment(x)):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    got = _kernel_order_3xtf32(once_q, once_c)
    want = _kernel_order_3xtf32(_split_per_fragment(qn), _split_per_fragment(cn))
    assert torch.equal(got, want)
    # product 2's B is cn transposed: the same split values, read by s
    cnt = split_tf32(cn.T.contiguous())
    assert all(torch.equal(a, b.T) for a, b in zip(cnt, once_c))


@pytest.mark.parametrize("d", [20, 36, 256])
def test_kernel_pass_order_lands_within_the_gate(d):
    """The kernel's order (per 8-deep k step: a_lo b_hi, a_hi b_lo, a_hi
    b_hi, f32 accumulation) on split-once rows lands within the 3xTF32 gate
    of the exact product, and within a few f32 roundings of the emulated
    plain version's order (each pass summed over all of D first); the
    product without its lo passes misses the gate by far."""
    qn = _normalised_rows(1, 99, d, seed=2 * d)
    cn = _normalised_rows(1, 240, d, seed=2 * d + 1)
    exact = _EINSUM("ld,sd->ls", qn.double(), cn.double())
    scale = float(exact.abs().max())
    got = _kernel_order_3xtf32(split_tf32(qn), split_tf32(cn))
    assert float((got.double() - exact).abs().max()) / scale <= SIM_GATE
    plain = einsum_3xtf32("ld,sd->ls", qn, cn)
    assert float((got - plain).abs().max()) / scale <= 1e-6
    (qh, _), (ch, _) = split_tf32(qn), split_tf32(cn)
    hi_only = _kernel_order_3xtf32((qh, torch.zeros_like(qh)), (ch, torch.zeros_like(ch)))
    assert float((hi_only.double() - exact).abs().max()) / scale > 10 * SIM_GATE


def two_pass_attention(q, k, v, bias):
    """The mma kernel's arithmetic on bf16 q, k, v and an f32 bias."""
    g, lq, _ = q.shape
    lk = k.shape[1]
    lk16 = -(-lk // 16) * 16
    x = _EINSUM("gqd,gkd->gqk", q.float(), k.float()) + bias[:, None, :].float()
    x = torch.cat([x, torch.full((g, lq, lk16 - lk), -torch.inf)], -1)  # padded keys
    m = torch.full((g, lq, 1), -torch.inf)
    s = torch.zeros((g, lq, 1))
    for j0 in range(0, lk16, 16):  # pass 1: max and sum, merged a chunk at a time
        chunk = x[..., j0:j0 + 16]
        mc = chunk.max(-1, keepdim=True).values
        mn = torch.maximum(m, mc)
        sc = torch.exp(chunk - mn).sum(-1, keepdim=True)
        s = torch.where(m == -torch.inf, 0.0, s * torch.exp(m - mn)) + sc
        m = mn
    p = (torch.exp(x - m) / s)[..., :lk].to(torch.bfloat16)  # pass 2
    return _EINSUM("gqk,gkd->gqd", p.float(), v.float()).to(torch.bfloat16)


def _attn_inputs(g, lq, lk, hd=64, seed=0):
    """As chip_smoke draws them: q scaled by hd^-0.5, bias 0 / -100, the
    first key visible, group 1 masked throughout."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(g, lq, hd).astype(np.float32)) * hd ** -0.5
    k = torch.from_numpy(rng.randn(g, lk, hd).astype(np.float32))
    v = torch.from_numpy(rng.randn(g, lk, hd).astype(np.float32))
    bias = torch.from_numpy(((rng.rand(g, lk) > 0.2).astype(np.float32) - 1.0) * 100.0)
    bias[:, 0] = 0.0
    bias[1] = -100.0
    return q.bfloat16(), k.bfloat16(), v.bfloat16(), bias


def _assert_bf16_close(got, want):
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    assert err <= BF16_REL * float(want.abs().max()), (err, float(want.abs().max()))


# the region tower's grouped shapes at f = 8 (few groups): space, time, the
# CLS row, full attention; then ragged ones (rows past a 16-row tile, keys
# past a 16-key chunk)
_TOWER = [(6, 30, 31), (6, 8, 9), (4, 1, 241), (3, 241, 241)]
_RAGGED = [(3, 16, 9), (3, 17, 256), (3, 16, 256), (3, 17, 9)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", _TOWER, ids=["space", "time", "cls", "full"])
def test_two_pass_softmax_matches_plain_at_tower_shapes(shape, seed):
    args = _attn_inputs(*shape, seed=seed)
    got = two_pass_attention(*args)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    _assert_bf16_close(got, ak.grouped_attention_plain(*args))


@pytest.mark.parametrize("shape", _RAGGED, ids=["16x9", "17x256", "16x256", "17x9"])
def test_two_pass_softmax_matches_plain_at_ragged_shapes(shape):
    args = _attn_inputs(*shape, seed=2)
    _assert_bf16_close(two_pass_attention(*args), ak.grouped_attention_plain(*args))


@pytest.mark.parametrize("shape", _TOWER, ids=["space", "time", "cls", "full"])
def test_two_pass_softmax_matches_jax_xla(shape):
    import jax.numpy as jnp

    from demovlp_tpu.ops.pallas_attention import grouped_attention_xla

    q, k, v, bias = _attn_inputs(*shape, seed=3)
    got = two_pass_attention(q, k, v, bias)
    want = grouped_attention_xla(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                                   for t in (q, k, v)), jnp.asarray(bias.numpy()))
    _assert_bf16_close(got, torch.from_numpy(np.array(want.astype(jnp.float32))))


BWD_PRODUCT_GATE = 1e-6  # f32 sums against float64, relative to the largest entry
BWD_BF16_TOL, BWD_FLIP_TOL, BWD_FLIP_SHARE = 2e-3, 2e-2, 1e-2  # chip_smoke TOL_TRAIN bf16


def _bwd_inputs(ls, lq, seed):
    """bf16-valued contexts and queries (chip_smoke's training inputs: ~30%
    of positions masked, item 1 masked throughout) and a cotangent."""
    ctx, cmask = _items(3, ls, 256, seed)
    qry, _ = _items(4, lq, 256, seed + 50)
    g = torch.from_numpy(np.random.RandomState(seed + 9).randn(3, 4).astype(np.float32))
    return xk.round_bf16(ctx), xk.round_bf16(qry), cmask, g


# (Ls, Lq): pre-training at f = 1 and the fine-tune lengths at f = 8, both directions
_BWD_SHAPES = [(30, 99), (99, 30), (240, 99), (99, 240)]
_BWD_IDS = ["i2t-f1", "t2i-f1", "i2t-f8", "t2i-f8"]


@pytest.mark.parametrize("focal", [False, True], ids=["prob", "equal"])
@pytest.mark.parametrize("ls,lq", _BWD_SHAPES, ids=_BWD_IDS)
def test_bf16_backward_products_differ_from_float64_only_in_order(ls, lq, focal, monkeypatch):
    """Each product of the bf16-mode backward (the recomputed forward's two,
    dph, dqn, dcn's two) on bf16-valued operands; its f32 sums within 1e-6
    of the float64 sums of the same operands."""
    ctx, qry, cmask, g = _bwd_inputs(ls, lq, 0)
    calls = []

    def recording(eq, a, b):
        out = _EINSUM(eq, a, b)
        calls.append((eq, a, b, out))
        return out

    monkeypatch.setattr(torch, "einsum", recording)
    xk.direction_sim_bwd_plain(ctx, qry, cmask, g, 20.0, focal, True)
    monkeypatch.undo()
    assert len(calls) == 6
    for eq, a, b, out in calls:
        for t in (a, b):
            assert torch.equal(xk.round_bf16(t), t), eq  # bf16 values
        exact = _EINSUM(eq, a.double(), b.double())
        err = float((out.double() - exact).abs().max()) / float(exact.abs().max())
        assert err <= BWD_PRODUCT_GATE, (eq, err)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("focal", [False, True], ids=["prob", "equal"])
@pytest.mark.parametrize("ls,lq", _BWD_SHAPES, ids=_BWD_IDS)
def test_bf16_backward_with_float64_products_within_card_tolerance(ls, lq, focal, seed,
                                                                   monkeypatch):
    """The whole bf16-mode backward with float64 products against the plain
    version's f32 products: within 2e-3 of the largest entry, or within 2e-2
    with at most 1% of the entries beyond 2e-3 (a later operand's bf16
    rounding can flip by one ulp when its f32 value moves in the last digit)."""
    ctx, qry, cmask, g = _bwd_inputs(ls, lq, seed)
    want = xk.direction_sim_bwd_plain(ctx, qry, cmask, g, 20.0, focal, True)
    monkeypatch.setattr(torch, "einsum", lambda eq, a, b: _EINSUM(eq, a.double(), b.double()).float())
    got = xk.direction_sim_bwd_plain(ctx, qry, cmask, g, 20.0, focal, True)
    monkeypatch.undo()
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        scale = float(b.abs().max())
        err = (a - b).abs()
        rel = float(err.max()) / scale
        share = float((err > BWD_BF16_TOL * scale).float().mean())
        assert rel <= BWD_BF16_TOL or (rel <= BWD_FLIP_TOL and share <= BWD_FLIP_SHARE), (rel, share)
    assert float(got[0][1].abs().max()) == 0.0  # a fully masked context item


def _mma_product(eq, a, b, k_axis_a, k_axis_b):
    """einsum(eq, a, b) as the bf16 mma tiles take it: exact products, each
    16-deep step of the contraction added to the f32 accumulator in k order
    (zero padding to a multiple of 16 adds nothing)."""
    k = a.shape[k_axis_a]
    acc = None
    for k0 in range(0, k, 16):
        step = _EINSUM(eq, a.narrow(k_axis_a, k0, min(16, k - k0)).double(),
                       b.narrow(k_axis_b, k0, min(16, k - k0)).double())
        acc = step.float() if acc is None else (acc.double() + step).float()
    return acc


def bf16_forward_emulated(ctx, qry, cmask, lam=20.0, focal=False):
    """sim (Bc, Bq) with the bf16 kernel's arithmetic, on inputs that hold
    bf16 values: the row norms in f32, qn and cn rounded to bf16; a0 = qn cn^T
    on mma steps; the score phases in f32 (zero-numerator divisions give 0);
    P rounded to bf16; w = P cn on mma steps; num and |w|^2 per 32-column
    chunk of D, the chunks added in order; the cosine against the raw query."""
    ls, lq, d = ctx.shape[1], qry.shape[1], ctx.shape[2]
    qn, q_norm = xk._normalise(qry)
    cn, _ = xk._normalise(ctx)
    qn, cn = xk.round_bf16(qn), xk.round_bf16(cn)
    a0 = _mma_product("qld,csd->cqls", qn, cn, 2, 2)
    a1 = torch.where(a0 >= 0, a0, 0.1 * a0)
    r = torch.sqrt(torch.sum(a1 * a1, dim=2, keepdim=True)) + xk._EPS
    a2 = torch.where(a1 != 0, a1 / r, 0.0)
    e = torch.exp((a2 + cmask[:, None, None, :]) * lam)

    def renorm(x):
        s = torch.sum(x, -1, keepdim=True)
        return torch.where((s > 0) & (x != 0), x / torch.where(s > 0, s, 1.0), 0.0)

    p = renorm(e)
    if focal:
        p = renorm(torch.where(p * ls - torch.sum(p, -1, keepdim=True) > 0, p, 0.0))
    w = _mma_product("cqls,csd->cqld", xk.round_bf16(p), cn, 3, 1)
    pad = -d % 32
    chunks = lambda t: torch.nn.functional.pad(t, (0, pad)).unflatten(-1, (-1, 32)).sum(-1)
    num_c, wsq_c = chunks(w * qry[None]), chunks(w * w)
    num, wsq = num_c[..., 0], wsq_c[..., 0]
    for ch in range(1, num_c.shape[-1]):
        num, wsq = num + num_c[..., ch], wsq + wsq_c[..., ch]
    cos = num / torch.clamp(torch.sqrt(wsq) * q_norm[None], min=xk._EPS)
    return torch.sum(cos, -1) / lq


def _assert_bf16_sims_close(got, want):
    scale = float(want.abs().max())
    err = (got - want).abs()
    rel = float(err.max()) / scale
    share = float((err > BWD_BF16_TOL * scale).float().mean())
    assert rel <= BWD_BF16_TOL or (rel <= BWD_FLIP_TOL and share <= BWD_FLIP_SHARE), (rel, share)


def _fwd_inputs(ls, lq, seed, d=256):
    """bf16-valued contexts and queries as chip_smoke's training inputs
    (~30% of positions masked, item 1 masked throughout)."""
    ctx, cmask = _items(3, ls, d, seed)
    qry, _ = _items(4, lq, d, seed + 50)
    return xk.round_bf16(ctx), xk.round_bf16(qry), cmask


@pytest.mark.parametrize("ls,lq", _BWD_SHAPES, ids=_BWD_IDS)
def test_bf16_forward_mma_products_within_f32_of_float64(ls, lq):
    """The emulated mma products (exact bf16 products, a 16-deep step at a
    time into f32) on the forward's own operands: within 1e-6 of float64
    sums of the same operands, so the kernel's order is no source of error
    beside the roundings it shares with the plain version."""
    ctx, qry, _ = _fwd_inputs(ls, lq, 3)
    qn = xk.round_bf16(xk._normalise(qry)[0])
    cn = xk.round_bf16(xk._normalise(ctx)[0])
    got = _mma_product("qld,csd->cqls", qn, cn, 2, 2)
    exact = _EINSUM("qld,csd->cqls", qn.double(), cn.double())
    err = float((got.double() - exact).abs().max()) / float(exact.abs().max())
    assert err <= BWD_PRODUCT_GATE, err


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("focal", [False, True], ids=["prob", "equal"])
@pytest.mark.parametrize("ls,lq", _BWD_SHAPES, ids=_BWD_IDS)
def test_bf16_forward_emulation_matches_plain(ls, lq, focal, seed):
    ctx, qry, cmask = _fwd_inputs(ls, lq, seed)
    got = bf16_forward_emulated(ctx, qry, cmask, 20.0, focal)
    want = xk.direction_sim_plain(ctx, qry, cmask, 20.0, focal, True)
    assert torch.isfinite(got).all()
    assert float(got[1].abs().max()) == 0.0  # a fully masked context item
    _assert_bf16_sims_close(got, want)


@pytest.mark.parametrize("focal", ["prob", "equal"])
@pytest.mark.parametrize("regions", [30, 240], ids=["f1", "f8"])
def test_bf16_forward_emulation_matches_jax_interpret(regions, focal):
    """Both directions (t2i.T + i2t) emulated against JAX's
    xattn_score_pallas_interpret(..., compute_dtype=bfloat16) on the same
    bf16-valued inputs, at the f = 1 and f = 8 lengths (99 words)."""
    import jax.numpy as jnp

    from demovlp_tpu.ops.pallas_xattn import xattn_score_pallas_interpret

    img, imask = _items(3, regions, 256, 7)
    txt, tmask = _items(4, 99, 256, 8)
    img, txt = xk.round_bf16(img), xk.round_bf16(txt)
    eq = focal == "equal"
    got = (bf16_forward_emulated(txt, img, tmask, 20.0, eq).T
           + bf16_forward_emulated(img, txt, imask, 20.0, eq))
    want = xattn_score_pallas_interpret(*(jnp.asarray(t.numpy()) for t in (img, txt, imask, tmask)),
                                        20.0, focal, compute_dtype=jnp.bfloat16)
    _assert_bf16_sims_close(got, torch.from_numpy(np.array(want, dtype=np.float32)))


def test_bf16_row_norm_rounding_is_round_bf16():
    """The row-norm pass's bf16 rounding (nearest even, as
    __float2bfloat16_rn) emulated by integer arithmetic equals round_bf16 bit
    for bit on the normalised rows and the raw rows of adversarial inputs:
    ties of both parities, subnormals, a zero row (norm exact, so
    x / (|x| + eps) is the value the card divides to)."""
    from tests.test_torch_kernel import adversarial_norm_rows, rne_bf16_bits

    x = torch.from_numpy(adversarial_norm_rows())
    xn, norm = xk._normalise(x)
    assert torch.equal(norm, torch.sqrt(torch.sum(x.double() ** 2, -1)).float())
    assert torch.equal(xn[:-1], x[:-1]) and float(xn[-1].abs().max()) == 0.0  # norms 1 and 0
    for t in (xn, x):
        want = xk.round_bf16(t).numpy().view(np.uint32) >> 16
        assert np.array_equal(rne_bf16_bits(t.numpy()).astype(np.uint32), want)
    ties = x.numpy().view(np.uint32) & 0xFFFF == 0x8000
    assert ties.sum() >= 16  # the rows do hold exact ties
