"""`loss.args.local_block_segment` and `local_remat` on the CPU: the port's
`GlobalLocalLoss` / `rwa_loss` against the JAX package's `rwa_loss` with
`block_segment` (its `xattn_score_blockwise`), on the XLA backend and on the
Pallas path in interpret mode (`xattn_score_pallas_interpret` put in place
of `ops.xattn.xattn_score` for the test, as the "pallas" backend would
route it on the TPU). The port scores each block through the kernels' plain
versions here.

Tolerances.
  * Blocked against unblocked, in the port. On the card each sim is
    computed pair by pair in a fixed order, so the blocked sims and loss
    are bit-identical there (chip_smoke.py [resume] holds that). The plain
    versions that run here are GEMMs whose summation order the CPU library
    picks from the block's item counts, so an f32 sim may move by an ulp or
    two: held within 8 f32 ulps (8 * 2^-24) of the largest |sim| (read on
    these inputs: 1.2e-7 at most, 0.82 the largest; in bf16 mode, whose
    products of bf16 operands are exact, read 0), the loss at rtol 1e-6
    (read 1.0e-7) and the gradients within 2e-6 of their largest entry
    (read 5.3e-7; the captions' gradient also sums its blocks' shares in
    another order).
  * Against JAX, f32: the loss at rtol 1e-4 (tests/test_torch_losses.py:
    summation order, amplified by lambda = 20) and the gradients at rtol
    1e-3 / atol 3e-5 (tests/test_torch_xattn_bwd.py's f32 limits). Read
    against the XLA backend: the loss within 6.2e-7 relative, the gradients
    within 1.5e-5 of their largest entry.
  * Against the Pallas path, bf16 mode: as tests/test_torch_xattn_bwd.py
    holds it (a last-digit difference before a bf16 rounding moves one
    gradient entry by an ulp): the loss at rtol 1e-3, at least 99% of the
    gradient entries at rtol 1e-2 / atol 3e-5 and every entry within 2^-7
    of the largest.
  * `local_remat`: identical loss and gradients (it changes nothing in the
    port).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demovlp_tpu.losses import losses as jl
from demovlp_tpu.ops import pallas_xattn
from demovlp_tpu.ops import xattn as jxattn
from demovlp_tpu_torch.losses import losses as tl

LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_TOL = dict(rtol=1e-3, atol=3e-5)
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_TOL = dict(rtol=1e-2, atol=3e-5)
BLOCK_SIM_ULPS = 8
BLOCK_LOSS_RTOL = 1e-6
BLOCK_GRAD_SCALED = 2e-6


def _inputs(b=8, r=5, w=7, d=16, seed=1):
    """Ragged -100 masks with every item keeping a position (the XLA path
    and the kernels differ on fully masked items only)."""
    rng = np.random.RandomState(seed)
    im = rng.randn(b, r, d).astype(np.float32)
    s = rng.randn(b, w, d).astype(np.float32)
    im_mask = ((rng.rand(b, r) > 0.3).astype(np.float32) - 1) * 100
    s_mask = ((rng.rand(b, w) > 0.3).astype(np.float32) - 1) * 100
    im_mask[:, 0] = 0.0
    s_mask[:, 0] = 0.0
    return im, s, im_mask, s_mask


def _port(inputs, segment, focal="equal", local_dtype="float32", remat=False, valid=None):
    """(loss, image grad, caption grad) of the port's RWA loss."""
    im, s, im_mask, s_mask = inputs
    ti = torch.from_numpy(im).requires_grad_()
    ts = torch.from_numpy(s).requires_grad_()
    loss_obj = tl.GlobalLocalLoss(focal_type=focal, local_dtype=local_dtype,
                                  local_block_segment=segment, local_remat=remat).local_loss
    loss = loss_obj(ti, ts, torch.from_numpy(im_mask), None, torch.from_numpy(s_mask),
                    None if valid is None else torch.from_numpy(valid))
    loss.backward()
    return loss.detach().numpy(), ti.grad.numpy(), ts.grad.numpy()


def _jax(inputs, segment, focal="equal", dtype=None):
    im, s, im_mask, s_mask = inputs

    def loss(i, c):
        return jl.rwa_loss(i, c, jnp.asarray(im_mask), jnp.asarray(s_mask), 20.0, focal,
                           block_segment=segment, compute_dtype=dtype)

    val, grads = jax.value_and_grad(loss, argnums=(0, 1))(jnp.asarray(im), jnp.asarray(s))
    return np.asarray(val), *(np.asarray(g) for g in grads)


def _grads_close(got, want, bf16: bool):
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        if not bf16:
            np.testing.assert_allclose(g, w, **GRAD_TOL)
            continue
        err = np.abs(g - w)
        beyond = err > BF16_GRAD_TOL["atol"] + BF16_GRAD_TOL["rtol"] * np.abs(w)
        assert beyond.mean() <= 0.01, (beyond.mean(), err.max())
        assert err.max() <= 2.0**-7 * np.abs(w).max()


@pytest.mark.parametrize("local_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("focal", ["prob", "equal"])
def test_blocked_sims_match_unblocked(focal, local_dtype):
    im, s, im_mask, s_mask = (torch.from_numpy(x) for x in _inputs())
    dtype = torch.bfloat16 if local_dtype == "bfloat16" else None
    whole = tl.local_scores(im, s, im_mask, s_mask, 20.0, focal, dtype)
    for segment in (2, 4):
        got = tl.local_scores(im, s, im_mask, s_mask, 20.0, focal, dtype, block_segment=segment)
        assert got.shape == whole.shape
        assert float((got - whole).abs().max()) <= BLOCK_SIM_ULPS * 2.0**-24 * float(
            whole.abs().max())


@pytest.mark.parametrize("with_valid", [False, True], ids=["all", "valid"])
def test_blocked_loss_and_grads_against_unblocked(with_valid):
    inputs = _inputs()
    valid = np.array([1, 1, 1, 0, 1, 1, 0, 1], np.float32) if with_valid else None
    l0, *g0 = _port(inputs, 0, valid=valid)
    l1, *g1 = _port(inputs, 4, valid=valid)
    np.testing.assert_allclose(l1, l0, rtol=BLOCK_LOSS_RTOL)
    for a, b in zip(g1, g0):
        assert np.abs(a - b).max() <= BLOCK_GRAD_SCALED * np.abs(b).max()


@pytest.mark.parametrize("focal", ["prob", "equal"])
def test_blocked_matches_jax_xla(focal):
    inputs = _inputs()
    want = _jax(inputs, 4, focal)
    got = _port(inputs, 4, focal)
    np.testing.assert_allclose(got[0], want[0], **LOSS_TOL)
    _grads_close(got[1:], want[1:], bf16=False)


@pytest.mark.parametrize("local_dtype", ["float32", "bfloat16"])
def test_blocked_matches_jax_pallas_interpret(local_dtype, monkeypatch):
    """JAX's blockwise path routed through the Pallas kernels in interpret
    mode; its jit caches are cleared before and after so no XLA-backend
    trace is reused and the patched one is not kept."""
    monkeypatch.setattr(jxattn, "xattn_score", pallas_xattn.xattn_score_pallas_interpret)
    jax.clear_caches()
    try:
        inputs = _inputs()
        bf16 = local_dtype == "bfloat16"
        want = _jax(inputs, 4, "equal", jnp.bfloat16 if bf16 else None)
    finally:
        monkeypatch.undo()
        jax.clear_caches()
    got = _port(inputs, 4, "equal", local_dtype)
    if bf16:
        np.testing.assert_allclose(got[0], want[0], rtol=BF16_LOSS_RTOL)
    else:
        np.testing.assert_allclose(got[0], want[0], **LOSS_TOL)
    _grads_close(got[1:], want[1:], bf16)


@pytest.mark.parametrize("b,segment", [(6, 4), (8, 8), (8, 16)],
                         ids=["not-dividing", "equal", "larger"])
def test_other_segments_score_unblocked(b, segment, monkeypatch):
    """JAX's exact condition: blocks only where segment < B and segment
    divides B; otherwise one call, as in JAX (whose loss it matches)."""
    calls = []
    kernel = tl.xattn_score_kernel
    monkeypatch.setattr(tl, "xattn_score_kernel",
                        lambda *a, **k: calls.append(a[0].shape[0]) or kernel(*a, **k))
    inputs = _inputs(b=b)
    got = _port(inputs, segment)
    assert calls == [b]
    np.testing.assert_allclose(got[0], _jax(inputs, segment)[0], **LOSS_TOL)
    calls.clear()
    _port(inputs, 2)  # and with a segment that blocks, one call a block
    assert calls == [2] * (b // 2)


@pytest.mark.parametrize("segment", [0, 4])
def test_local_remat_is_identical(segment):
    inputs = _inputs()
    a = _port(inputs, segment, remat=False)
    b = _port(inputs, segment, remat=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
