"""The numerics of the port's tensor-core kernels, pinned on the CPU by
emulating them in torch.

* The f32 local-similarity forward (csrc/xattn_sim_fwd.cu,
  xattn_sim_fwd_tf32_kernel) takes each product as 3xTF32: every f32
  operand x is split into hi = tf32(x) and lo = tf32(x - hi), rounded as
  cvt.rna.tf32.f32 rounds (to nearest, ties away from zero), and
  a b = a_lo b_hi + a_hi b_lo + a_hi b_hi with f32 sums. Here the plain
  version `direction_sim_plain` runs with its two products emulated that
  way (torch.einsum patched for the test), and must stay within 1e-6 of the
  f32 plain version's largest sim at the serving and training shapes,
  both directions and both focal types. A single TF32 pass must miss that
  gate by more than 1e-5 somewhere: the control that shows the gate tells
  the two apart.
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
