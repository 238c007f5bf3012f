"""The local similarity's gradients: the port's differentiable direction
(`DirectionSim`, summed as t2i.T + i2t by `xattn_score_kernel`) on the CPU,
where it runs the plain versions of the kernels, against `jax.grad` of the
JAX package's Pallas path in interpret mode (`xattn_score_pallas_interpret`,
whose backward is the two Pallas backward kernels), with a random
cotangent; and the plain analytic backward against torch.autograd through
the plain forward.

Tolerances.
  * f32: the forward at rtol 1e-4 / atol 2e-5 and the gradients at rtol
    1e-3 / atol 3e-5, the ones tests/test_pallas.py holds the Pallas kernel
    to against XLA (summation order only).
  * bf16: both sides round the same operands to bf16, and each direction's
    gradient leaves rounded to bf16 before the two are summed. A last-digit
    difference before that rounding flips it by one bf16 ulp (2^-8 of that
    direction's value), which is large against the sum where the two
    directions cancel. So at least 99% of the gradient entries are held at
    rtol 1e-2 / atol 3e-5 and every entry within 2^-7 of the gradient's
    largest magnitude; the forward (f32 after the rounded products) at the
    f32 tolerance.
  * plain backward vs autograd (f32, the same plain forward): 1e-5 / 1e-7.
  * plain backward, blocked and in one block, vs float64: see
    test_plain_backward_blocking_matches_one_block.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demovlp_tpu.ops.pallas_xattn import xattn_score_pallas_interpret
from demovlp_tpu_torch.ops import xattn_kernel as xk

FWD_TOL = dict(rtol=1e-4, atol=2e-5)
GRAD_TOL = dict(rtol=1e-3, atol=3e-5)
BF16_GRAD_TOL = dict(rtol=1e-2, atol=3e-5)
BWD_F64_ULPS = 64  # f32 vs float64, in units of 2^-24 of the largest |entry|


def _inputs(ni, nc, r, w, d=32, seed=0):
    """Ragged -100 masks; trailing positions of two items are inert padding
    (zero vectors under -100), and image 1 is fully masked."""
    rng = np.random.RandomState(seed)
    img = rng.randn(ni, r, d).astype(np.float32)
    lang = rng.randn(nc, w, d).astype(np.float32)
    imask = ((rng.rand(ni, r) > 0.2).astype(np.float32) - 1) * 100
    lmask = ((rng.rand(nc, w) > 0.2).astype(np.float32) - 1) * 100
    img[0, r // 2:] = 0.0
    imask[0, r // 2:] = -100.0
    lang[-1, w // 2:] = 0.0
    lmask[-1, w // 2:] = -100.0
    imask[1] = -100.0
    g = rng.randn(ni, nc).astype(np.float32)
    return img, lang, imask, lmask, g


def _jax_value_and_grads(img, lang, imask, lmask, g, focal, bf16):
    dtype = jnp.bfloat16 if bf16 else None
    im_j, lm_j, g_j = jnp.asarray(imask), jnp.asarray(lmask), jnp.asarray(g)

    def loss(i, l):
        s = xattn_score_pallas_interpret(i, l, im_j, lm_j, 20.0, focal, compute_dtype=dtype)
        return jnp.sum(s * g_j), s

    (_, sims), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(img), jnp.asarray(lang))
    return np.asarray(sims), [np.asarray(x) for x in grads]


def _assert_grad_close(got, ref, mode):
    if mode == "f32":
        np.testing.assert_allclose(got, ref, **GRAD_TOL)
        return
    err = np.abs(got - ref)
    beyond = err > BF16_GRAD_TOL["atol"] + BF16_GRAD_TOL["rtol"] * np.abs(ref)
    assert beyond.mean() <= 0.01, (beyond.mean(), err.max())
    assert err.max() <= 2.0**-7 * np.abs(ref).max(), (err.max(), np.abs(ref).max())


_CASES = [(s, f, m) for s in [(6, 5, 7, 9, 32), (8, 8, 30, 20, 32)]
          for f in ("prob", "equal") for m in ("f32", "bf16")]
_CASES.append(((5, 7, 11, 6, 20), "equal", "bf16"))  # ragged, odd Lq, D = 20
# the fine-tune shapes, f = 8 x k = 30 regions and 99 words, with few items
# and a small D: (Lq, Ls) = (99, 240) for i2t and (240, 99) for t2i
_CASES += [((2, 3, 240, 99, 8), f, m) for f, m in (("equal", "f32"), ("prob", "bf16"))]


@pytest.mark.parametrize("shape,focal,mode", _CASES,
                         ids=["-".join(map(str, c[0][:4])) + f"-{c[1]}-{c[2]}" for c in _CASES])
def test_grads_match_pallas_interpret(shape, focal, mode):
    ni, nc, r, w, d = shape
    img, lang, imask, lmask, g = _inputs(ni, nc, r, w, d=d, seed=3)
    want, want_grads = _jax_value_and_grads(img, lang, imask, lmask, g, focal, mode == "bf16")
    ti = torch.from_numpy(img).requires_grad_()
    tl = torch.from_numpy(lang).requires_grad_()
    sims = xk.xattn_score_kernel(ti, tl, torch.from_numpy(imask), torch.from_numpy(lmask),
                                 20.0, focal,
                                 compute_dtype=torch.bfloat16 if mode == "bf16" else None)
    (sims * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(sims.detach().numpy(), want, **FWD_TOL)
    for got, ref in ((ti.grad.numpy(), want_grads[0]), (tl.grad.numpy(), want_grads[1])):
        assert np.isfinite(got).all()
        _assert_grad_close(got, ref, mode)
    # the fully masked image item scores 0 where it is the context (p = 0)
    i2t = xk.direction_sim(torch.from_numpy(img), torch.from_numpy(lang),
                           torch.from_numpy(imask), 20.0, focal == "equal")
    np.testing.assert_array_equal(i2t[1].numpy(), np.zeros(nc, np.float32))


@pytest.mark.parametrize("focal", [False, True], ids=["prob", "equal"])
def test_plain_backward_matches_autograd(focal):
    """Non-degenerate inputs (no masked-out item, no zero row), f32."""
    rng = np.random.RandomState(7)
    ctx = torch.from_numpy(rng.randn(5, 7, 16).astype(np.float32)).requires_grad_()
    qry = torch.from_numpy(rng.randn(6, 9, 16).astype(np.float32)).requires_grad_()
    mask = torch.from_numpy(((rng.rand(5, 7) > 0.3).astype(np.float32) - 1) * 100)
    mask[:, 0] = 0.0
    g = torch.from_numpy(rng.randn(5, 6).astype(np.float32))
    sim = xk.direction_sim_plain(ctx, qry, mask, 20.0, focal)
    want_dc, want_dq = torch.autograd.grad((sim * g).sum(), (ctx, qry))
    dc, dq = xk.direction_sim_bwd_plain(ctx.detach(), qry.detach(), mask, g, 20.0, focal)
    np.testing.assert_allclose(dc.numpy(), want_dc.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(dq.numpy(), want_dq.numpy(), rtol=1e-5, atol=1e-7)


def test_plain_backward_blocking_matches_one_block():
    """More than one 64-item block a side: the blocked sums of the plain
    backward, and the same backward over one block of everything, are each
    held against a float64 evaluation of the same function
    (`_backward_block` and `_unit_backward` on `.double()` inputs).

    Bound: BWD_F64_ULPS = 64 units of f32 rounding (2^-24) of the float64
    result's largest |entry|, per gradient. Blocking only reorders f32
    sums, and f32 addition is not associative, so the two f32 results are
    not equal; each is a rounding of the float64 value. Each gradient entry
    chains sums over Lq, Ls, D and up to 70 partner items, and the
    differences one BLAS blocking or another gives read 15-19 units of the
    largest entry here. The blocked and the one-block results differ from
    each other by at most twice the bound."""
    rng = np.random.RandomState(8)
    ctx = torch.from_numpy(rng.randn(70, 4, 8).astype(np.float32))
    qry = torch.from_numpy(rng.randn(66, 5, 8).astype(np.float32))
    mask = torch.zeros(70, 4)
    g = torch.from_numpy(rng.randn(70, 66).astype(np.float32))
    blocked = xk.direction_sim_bwd_plain(ctx, qry, mask, g, 20.0, True)
    dq_direct, dqn, dcn = xk._backward_block(ctx, qry, mask, g, 20.0, True, False)
    whole = (xk._unit_backward(dcn, ctx), dq_direct + xk._unit_backward(dqn, qry))
    c64, q64 = ctx.double(), qry.double()
    dq_direct, dqn, dcn = xk._backward_block(c64, q64, mask.double(), g.double(), 20.0, True,
                                             False)
    exact = (xk._unit_backward(dcn, c64), dq_direct + xk._unit_backward(dqn, q64))
    for a, b, want in zip(blocked, whole, exact):
        assert a.dtype == b.dtype == torch.float32
        bound = BWD_F64_ULPS * 2.0 ** -24 * float(want.abs().max())
        assert float((a.double() - want).abs().max()) <= bound
        assert float((b.double() - want).abs().max()) <= bound
        assert float((a - b).abs().max()) <= 2 * bound


def test_mask_gets_no_gradient_and_cpu_never_launches():
    img, lang, imask, lmask, _ = _inputs(3, 4, 5, 6, d=8, seed=1)
    m = torch.from_numpy(imask).requires_grad_()
    before = dict(xk.LAUNCHES)
    sims = xk.xattn_score_kernel(torch.from_numpy(img).requires_grad_(), torch.from_numpy(lang),
                                 m, torch.from_numpy(lmask), 20.0, "equal")
    sims.sum().backward()
    assert m.grad is None
    assert xk.LAUNCHES == before


@pytest.mark.parametrize(
    "change,err",
    [
        (lambda c, q, m, g: (c, q, m, g.double()), TypeError),
        (lambda c, q, m, g: (c, q, m, g[:, :-1].contiguous()), ValueError),
        (lambda c, q, m, g: (c, q, m, torch.zeros(4, 3).T), ValueError),
    ],
    ids=["dtype", "shape", "contiguity"],
)
def test_bwd_launch_checks_arguments(change, err):
    """Checked before anything is built or launched."""
    rng = np.random.RandomState(2)
    c = torch.from_numpy(rng.randn(3, 5, 8).astype(np.float32))
    q = torch.from_numpy(rng.randn(4, 6, 8).astype(np.float32))
    m = torch.zeros(3, 5)
    g = torch.zeros(3, 4)
    before = dict(xk.LAUNCHES)
    with pytest.raises(err):
        xk._launch_bwd(xk.KERNEL_DQ, *change(c, q, m, g), 20.0, True, False)
    assert xk.LAUNCHES == before


# ---- the backward kernels' split of the partner loop over S blocks an item
# (ops/xattn_kernel.py::backward_splits; the reduce kernels' semantics)


def _pair_steps(items, partners, slots, s):
    return -(-items * s // slots) * -(-partners // s)


@pytest.mark.parametrize("items,partners,slots,want", [
    (32, 32, 132, 4),  # f = 8 fine-tune: 128 blocks of 8 partners
    (128, 128, 132, 1),  # f = 1 pre-training, one block an SM
    (128, 128, 264, 2),  # f = 1 where two blocks fit an SM
    (40, 1, 132, 1),  # one partner
    (1, 9, 132, 9),  # one item: a block a partner
    (200, 50, 132, 1),  # the items alone fill the slots
], ids=["f8", "f1", "f1-two-a-sm", "one-partner", "one-item", "items-past-slots"])
def test_backward_splits_at_known_shapes(items, partners, slots, want):
    assert xk.backward_splits(items, partners, slots) == want


def test_backward_splits_is_the_smallest_minimum_within_one_wave():
    """Brute force over S <= partners on a grid of small cases: S minimises
    the pair-steps on the busiest slot among the splits that keep the grid
    within one wave of the slots (or S = 1), and no smaller S does as well."""
    for items in range(1, 13):
        for partners in range(1, 15):
            for slots in (1, 2, 3, 5, 8, 13, 24):
                s = xk.backward_splits(items, partners, slots)
                assert 1 <= s <= partners
                allowed = [t for t in range(1, partners + 1) if t == 1 or items * t <= slots]
                best = min(_pair_steps(items, partners, slots, t) for t in allowed)
                assert s in allowed
                assert _pair_steps(items, partners, slots, s) == best
                assert all(_pair_steps(items, partners, slots, t) > best
                           for t in allowed if t < s)


def _ranges(partners, splits):
    """The partner ranges of the kernels' blocks s = 0 .. S - 1."""
    return [slice(s * partners // splits, (s + 1) * partners // splits) for s in range(splits)]


@pytest.mark.parametrize("splits", [1, 3], ids=["S1", "S3-ragged"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_split_partials_reduce_to_the_plain_backward(splits, bf16):
    """What the main and reduce kernels compute, written with the plain
    pieces: each block (item, s) sums `_backward_block` over its partner
    range; d_query's two partials hold dq_direct and dqn, d_context's dcn;
    the reduce sums the S partials in order and applies the qn / cn
    backward to the totals. That must match `direction_sim_bwd_plain`
    within 1e-5 of its largest entry. The partner count (7 contexts, 8
    queries) is not a multiple of S = 3."""
    rng = np.random.RandomState(11)
    ctx = torch.from_numpy(rng.randn(7, 6, 12).astype(np.float32))
    qry = torch.from_numpy(rng.randn(8, 5, 12).astype(np.float32))
    if bf16:
        ctx, qry = xk.round_bf16(ctx), xk.round_bf16(qry)
    mask = torch.from_numpy(((rng.rand(7, 6) > 0.3).astype(np.float32) - 1) * 100)
    mask[2] = -100.0  # a fully masked context item
    g = torch.from_numpy(rng.randn(7, 8).astype(np.float32))
    args = (20.0, True, bf16)
    part_direct, part_dqn, part_dcn = [], [], []
    for cs in _ranges(7, splits):  # d_query: partners are the contexts
        dq_direct, dqn, _ = xk._backward_block(ctx[cs], qry, mask[cs], g[cs], *args)
        part_direct.append(dq_direct)
        part_dqn.append(dqn)
    for qs in _ranges(8, splits):  # d_context: partners are the queries
        part_dcn.append(xk._backward_block(ctx, qry[qs], mask, g[:, qs], *args)[2])
    dq = sum(part_direct) + xk._unit_backward(sum(part_dqn), qry)
    dc = xk._unit_backward(sum(part_dcn), ctx)
    want_dc, want_dq = xk.direction_sim_bwd_plain(ctx, qry, mask, g, *args)
    for got, want in ((dc, want_dc), (dq, want_dq)):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * scale
    assert float(dc[2].abs().max()) == 0.0
