"""The port's local-similarity ops against the JAX package: the plain
`xattn_score` against `_xattn_score_xla` and the Pallas kernel in interpret
mode, the kernel-semantics plain version (what a CPU tensor gets from the
kernel wrapper) against the interpret kernel, and the one-card gallery
chunking against `sharded_local_sims` on a 1-device CPU mesh.

Tolerance rtol 1e-4, atol 2e-5: the one tests/test_pallas.py holds the
Pallas kernel to against XLA (f32 on both sides, different summation order).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demovlp_tpu.ops.pallas_xattn import xattn_score_pallas_interpret
from demovlp_tpu.ops.xattn import _xattn_score_xla
from demovlp_tpu.parallel import create_mesh
from demovlp_tpu.parallel.sharded_eval import sharded_local_sims as jax_local_sims
from demovlp_tpu_torch.ops import masking, similarity
from demovlp_tpu_torch.ops.xattn import xattn_score
from demovlp_tpu_torch.ops.xattn_kernel import (LAUNCHES, _block_plain,
                                                direction_sim,
                                                direction_sim_plain,
                                                xattn_score_kernel)
from demovlp_tpu_torch.parallel.sharded_eval import sharded_local_sims

TOL = dict(rtol=1e-4, atol=2e-5)
SHAPES = [(6, 5, 7, 9), (8, 8, 30, 20)]


def _inputs(ni, nc, r, w, d=32, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.randn(ni, r, d).astype(np.float32)
    lang = rng.randn(nc, w, d).astype(np.float32)
    imask = ((rng.rand(ni, r) > 0.2).astype(np.float32) - 1) * 100
    lmask = ((rng.rand(nc, w) > 0.2).astype(np.float32) - 1) * 100
    return img, lang, imask, lmask


def _jax(fn, *arrays, focal):
    return np.asarray(fn(*(jnp.asarray(a) for a in arrays), 20.0, focal))


def _port(fn, *arrays, focal):
    return fn(*(torch.from_numpy(a) for a in arrays), 20.0, focal).numpy()


@pytest.mark.parametrize("focal", ["prob", "equal"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_xattn_matches_xla_and_interpret(shape, focal):
    arrays = _inputs(*shape)
    got = _port(xattn_score, *arrays, focal=focal)
    np.testing.assert_allclose(got, _jax(_xattn_score_xla, *arrays, focal=focal), **TOL)
    np.testing.assert_allclose(
        got, _jax(xattn_score_pallas_interpret, *arrays, focal=focal), **TOL
    )


@pytest.mark.parametrize("focal", ["prob", "equal"])
@pytest.mark.parametrize("shape", SHAPES + [(70, 67, 5, 4)])  # last: past one 64-item block
def test_kernel_plain_matches_interpret(shape, focal):
    arrays = _inputs(*shape, seed=1)
    before = LAUNCHES["xattn_sim_fwd"]
    got = _port(xattn_score_kernel, *arrays, focal=focal)
    assert LAUNCHES["xattn_sim_fwd"] == before  # CPU tensors never launch
    np.testing.assert_allclose(
        got, _jax(xattn_score_pallas_interpret, *arrays, focal=focal), **TOL
    )


@pytest.mark.parametrize("focal", ["prob", "equal"])
def test_inert_padded_gallery_rows(focal):
    """Zero-feature rows with an all -100 mask (the eval chunk padding)
    leave the kept rows unchanged, on both port paths."""
    img, lang, imask, lmask = _inputs(6, 5, 7, 9, seed=2)
    want = _jax(_xattn_score_xla, img, lang, imask, lmask, focal=focal)
    img_p = np.concatenate([img, np.zeros((3,) + img.shape[1:], np.float32)])
    imask_p = np.concatenate([imask, np.full((3, imask.shape[1]), -100.0, np.float32)])
    for fn in (xattn_score, xattn_score_kernel):
        got = _port(fn, img_p, lang, imask_p, lmask, focal=focal)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got[:6], want, **TOL)


@pytest.mark.parametrize("focal", ["prob", "equal"])
def test_fully_masked_row_follows_the_kernel(focal):
    """A real item whose every position is masked: the kernel's softmax
    without a max pass gives p = 0 there (the XLA path gives a uniform
    row), and the plain version must follow the kernel."""
    img, lang, imask, lmask = _inputs(6, 5, 7, 9, seed=3)
    imask[2] = -100.0
    lmask[1] = -100.0
    got = _port(xattn_score_kernel, img, lang, imask, lmask, focal=focal)
    np.testing.assert_allclose(
        got, _jax(xattn_score_pallas_interpret, img, lang, imask, lmask, focal=focal), **TOL
    )


def test_direction_sim_plain_blocking_is_exact():
    """More items than one 64-item block on both sides: blocking the plain
    version changes nothing, since each output element comes from one
    (context, query) pair."""
    img, lang, imask, _ = _inputs(70, 67, 7, 9, d=16, seed=4)
    for focal in (False, True):
        args = (torch.from_numpy(img), torch.from_numpy(lang), torch.from_numpy(imask),
                20.0, focal)
        whole = _block_plain(*args)  # one block over everything
        blocked = direction_sim_plain(*args)
        np.testing.assert_allclose(blocked.numpy(), whole.numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(direction_sim(*args).numpy(), blocked.numpy())


def test_direction_sim_rejects_other_devices():
    t = torch.zeros((1, 2, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        direction_sim(t, t, torch.zeros((1, 2), device="meta"))


@pytest.mark.parametrize("focal", ["prob", "equal"])
def test_chunked_local_sims_match_jax(focal):
    """Gallery chunks and caption blocks smaller than the inputs, with
    ragged last chunks padded by inert rows, against the JAX one-device
    mesh path (whose CPU backend scores with XLA)."""
    img, lang, imask, lmask = _inputs(11, 10, 7, 9, seed=5)
    mesh = create_mesh(devices=jax.devices()[:1])
    want = jax_local_sims(img, lang, imask, lmask, mesh, lambda_softmax=20.0,
                          focal_type=focal, chunk_rows=4, cap_chunk_rows=4)
    got = sharded_local_sims(img, lang, imask, lmask, device="cpu",
                             lambda_softmax=20.0, focal_type=focal,
                             chunk_rows=4, cap_chunk_rows=4)
    assert got.shape == (11, 10)
    np.testing.assert_allclose(got, want, **TOL)


def test_masking_and_similarity_match_jax():
    from demovlp_tpu.ops import masking as jm
    from demovlp_tpu.ops import similarity as js

    rng = np.random.RandomState(6)
    a = rng.randn(5, 16).astype(np.float32)
    b = rng.randn(7, 16).astype(np.float32)
    b[3] = 0.0  # zero row: the eps floor / eps-in-denominator matter
    m = (rng.rand(5, 16) > 0.5).astype(np.int32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(masking.additive_mask(torch.from_numpy(m)).numpy(),
                                  np.asarray(jm.additive_mask(jnp.asarray(m))))
    np.testing.assert_allclose(masking.l2norm(tb).numpy(),
                               np.asarray(jm.l2norm(jnp.asarray(b))), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(similarity.sim_matrix(ta, tb).numpy(),
                               np.asarray(js.sim_matrix(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        similarity.cosine_similarity(ta, tb[:5]).numpy(),
        np.asarray(js.cosine_similarity(jnp.asarray(a), jnp.asarray(b[:5]))),
        rtol=1e-5, atol=1e-6,
    )
