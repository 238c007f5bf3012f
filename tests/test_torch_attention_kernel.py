"""Grouped attention (demovlp_tpu_torch.ops.attention_kernel) against the
JAX package's demovlp_tpu.ops.pallas_attention: the plain version and the
trainable `GroupedAttentionFused` on the CPU against `grouped_attention_xla`
and against `grouped_attention_pallas(..., interpret=True)`, on the inputs
of tests/test_pallas_attention.py plus Lk > 128 and bf16; the gradients
against `jax.vjp(grouped_attention_xla)`. The CUDA kernel runs only on a
card (`gpu` marker, skipped here when no card is visible, decided in the
test body), where it is held against the plain version. JAX is imported
inside the tests that use it, so the card's machine, which has no JAX,
collects this file.

Tolerances.
  * f32: rtol 1e-5 / atol 1e-6, what tests/test_pallas_attention.py holds
    the Pallas kernel to against XLA (summation order only), at its Lk = 7;
    at Lk = 141 the second product sums 20 times as many terms of order 1,
    and the differences read up to 2.7e-6, so atol 1e-5 there.
  * bf16 results: the probabilities and the result are rounded to bf16 on
    both sides, so a last-digit difference before a rounding moves an
    entry by one bf16 ulp; every entry within 2^-7 of the result's largest
    magnitude (two ulps at that scale).
  * kernel vs plain on the card: f32 1e-5 of the largest magnitude (the
    card's expf and summation order); bf16 as above.

The padding case. The Pallas wrapper pads Lk to 128 lanes with a bias of
-1e9. Where every real key of a group also has a bias <= -1e9, its softmax
spreads over the padded keys (zero values) too, and its result differs from
`grouped_attention_xla`, which averages over the real keys. The port
follows `grouped_attention_xla`; `test_bias_at_the_padding_value` states
the case, and it stays out of the kernel-vs-Pallas comparisons.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from demovlp_tpu_torch.ops import attention_kernel as ak

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(rtol=1e-5, atol=1e-6)
F32_LONG = dict(rtol=1e-5, atol=1e-5)  # Lk = 141
BF16_REL = 2.0 ** -7


def _inputs(g=10, lq=6, lk=7, hd=12, seed=0):
    """As tests/test_pallas_attention.py draws them: bias 0 / -100."""
    rng = np.random.RandomState(seed)
    q = rng.randn(g, lq, hd).astype(np.float32)
    k = rng.randn(g, lk, hd).astype(np.float32)
    v = rng.randn(g, lk, hd).astype(np.float32)
    bias = ((rng.rand(g, lk) > 0.2).astype(np.float32) - 1) * 100
    return q, k, v, bias


def _jax(fn, q, k, v, bias, dtype=None, **kw):
    import jax.numpy as jnp

    args = [jnp.asarray(x) for x in (q, k, v)]
    if dtype is not None:
        args = [x.astype(dtype) for x in args]
    return np.asarray(fn(*args, jnp.asarray(bias), **kw).astype(jnp.float32))


def _torch(q, k, v, bias, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in (q, k, v)] + [torch.from_numpy(bias)]


def _assert_bf16_close(got, want):
    err = np.abs(got - want).max()
    assert err <= BF16_REL * np.abs(want).max(), (err, np.abs(want).max())


_SHAPES = [(10, 6, 7, 12), (4, 3, 141, 16)]  # the JAX test's inputs; Lk > 128


@pytest.mark.parametrize("shape", _SHAPES, ids=["jax-test", "lk141"])
def test_plain_matches_xla_and_pallas_f32(shape):
    from demovlp_tpu.ops.pallas_attention import (grouped_attention_pallas,
                                                  grouped_attention_xla)

    q, k, v, bias = _inputs(*shape)
    bias[0] = -100.0  # a fully masked group (the JAX test's value)
    tol = F32 if shape[2] < 128 else F32_LONG
    got = ak.grouped_attention(*_torch(q, k, v, bias)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax(grouped_attention_xla, q, k, v, bias), **tol)
    np.testing.assert_allclose(
        got, _jax(grouped_attention_pallas, q, k, v, bias, interpret=True), **tol)


@pytest.mark.parametrize("shape", _SHAPES, ids=["jax-test", "lk141"])
def test_plain_matches_xla_and_pallas_bf16(shape):
    import jax.numpy as jnp

    from demovlp_tpu.ops.pallas_attention import (grouped_attention_pallas,
                                                  grouped_attention_xla)

    q, k, v, bias = _inputs(*shape, seed=1)
    got = ak.grouped_attention(*_torch(q, k, v, bias, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    _assert_bf16_close(got, _jax(grouped_attention_xla, q, k, v, bias, jnp.bfloat16))
    _assert_bf16_close(got, _jax(grouped_attention_pallas, q, k, v, bias, jnp.bfloat16,
                                 interpret=True))


def test_bias_at_the_padding_value():
    """Every real key of group 0 at -1e9 and |q.k| < 32, so every logit of
    the group rounds to -1e9 exactly: the plain version and XLA give the
    mean of the group's values, and the Pallas kernel, whose padded keys
    sit at -1e9 too, that mean scaled by Lk / 128."""
    from demovlp_tpu.ops.pallas_attention import (grouped_attention_pallas,
                                                  grouped_attention_xla)

    q, k, v, bias = _inputs(g=3, lq=2, lk=5, hd=8, seed=2)
    q *= 0.01
    bias[0] = -1e9
    got = ak.grouped_attention(*_torch(q, k, v, bias)).numpy()
    mean = np.broadcast_to(v[0].mean(0), got[0].shape)
    np.testing.assert_allclose(got[0], mean, **F32)
    np.testing.assert_allclose(got, _jax(grouped_attention_xla, q, k, v, bias), **F32)
    pallas = _jax(grouped_attention_pallas, q, k, v, bias, interpret=True)
    np.testing.assert_allclose(pallas[0], mean * 5 / 128, **F32)
    np.testing.assert_allclose(pallas[1:], got[1:], **F32)


def test_fused_forward_and_gradients_match_jax_vjp():
    import jax
    import jax.numpy as jnp

    from demovlp_tpu.ops.pallas_attention import grouped_attention_xla

    q, k, v, bias = _inputs(g=6, lq=4, lk=9, hd=8, seed=3)
    bias[2] = -100.0
    cot = np.random.RandomState(4).randn(6, 4, 8).astype(np.float32)
    want, vjp = jax.vjp(grouped_attention_xla, *(jnp.asarray(x) for x in (q, k, v, bias)))
    want_grads = vjp(jnp.asarray(cot))
    leaves = [t.requires_grad_() for t in _torch(q, k, v, bias)]
    before = dict(ak.LAUNCHES)
    out = ak.grouped_attention_fused(*leaves)
    out.backward(torch.from_numpy(cot))
    assert ak.LAUNCHES == before  # CPU tensors never reach the kernel
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **F32)
    for t, w in zip(leaves, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "change,err",
    [
        (lambda q, k, v, b: (q.double(), k.double(), v.double(), b), TypeError),
        (lambda q, k, v, b: (q, k.bfloat16(), v, b), TypeError),
        (lambda q, k, v, b: (q, k[:, :-1].contiguous(), v, b), ValueError),
        (lambda q, k, v, b: (q, k, v, b[:, :-1].contiguous()), ValueError),
        (lambda q, k, v, b: (q.transpose(1, 2), k, v, b), ValueError),
    ],
    ids=["dtype", "mixed-dtype", "kv-shape", "bias-shape", "contiguity"],
)
def test_kernel_wrapper_checks_arguments(change, err):
    """Checked before anything is built or launched."""
    args = change(*_torch(*_inputs(g=3, lq=4, lk=4, hd=4)))
    before = dict(ak.LAUNCHES)
    with pytest.raises(err):
        ak.grouped_attention_kernel(*args)
    assert ak.LAUNCHES == before


def test_build_model_rejects_attn_impl_pallas():
    from demovlp_tpu_torch.cli.common import build_model

    cfg = json.loads((ROOT / "configs" / "smoke" / "synthetic_retrieval.json").read_text())
    cfg["arch"]["args"]["object_params"]["attn_impl"] = "pallas"
    with pytest.raises(ValueError, match="was removed"):
        build_model(cfg)


# the region tower's grouped shapes at f = 8, k = 30, 12 heads, hd = 64,
# cut to a few groups: space (Lq 30, Lk 31), time (8, 9), the CLS row
# (1, 241), full attention (241, 241)
_CARD = [(7, 30, 31), (13, 8, 9), (5, 1, 241), (3, 241, 241)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", _CARD, ids=["space", "time", "cls", "full"])
def test_kernel_matches_plain_on_card(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from demovlp_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    g, lq, lk = shape
    q, k, v, bias = _inputs(g, lq, lk, 64, seed=5)
    q *= 64 ** -0.5
    bias[1] = -100.0  # a fully masked group
    args = [t.to(dev) for t in _torch(q, k, v, bias, dtype)]
    before = ak.LAUNCHES[ak.KERNEL]
    got = ak.grouped_attention(*args)
    want = ak.grouped_attention_plain(*args)
    torch.cuda.synchronize()
    assert ak.LAUNCHES[ak.KERNEL] == before + 1
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    if dtype == torch.float32:
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    else:
        _assert_bf16_close(got, want)


@pytest.mark.gpu
def test_kernel_refuses_keys_too_large_for_a_block():
    """Lk = 1000 keys of hd = 64: one group's keys and values (about 520 KB
    as f32) exceed one block's shared memory; the wrapper raises and counts
    nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from demovlp_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    args = [t.to(dev) for t in _torch(*_inputs(2, 3, 1000, 64))]
    before = dict(ak.LAUNCHES)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        ak.grouped_attention(*args)
    assert ak.LAUNCHES == before
