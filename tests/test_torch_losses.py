"""The port's retrieval losses against demovlp_tpu.losses in f32 on the CPU,
with the same numpy inputs: `norm_softmax_loss` with and without `valid`,
`rwa_loss` (its KL over the local scores), and `GlobalLocalLoss`'s
(total, global, local).

The JAX losses score the local sims through `ops.xattn.xattn_score` on its
default "xla" backend; the port's go through the kernel's plain version.
The two agree except on fully masked rows, which these inputs do not have.
Tolerance: rtol 1e-5 / atol 1e-6 (f32, summation order only); the local
loss multiplies the scores by lambda = 20 before its softmax, so it is held
at rtol 1e-4.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demovlp_tpu.losses import losses as jl
from demovlp_tpu_torch.losses import losses as tl

TOL = dict(rtol=1e-5, atol=1e-6)
LOCAL_TOL = dict(rtol=1e-4, atol=1e-6)


def _sim(n=9, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, n).astype(np.float32)
    return np.tanh(x)  # cosine-like range


def _valid(n=9):
    v = np.ones(n, np.float32)
    v[-3:] = 0.0  # padded tail rows
    return v


@pytest.mark.parametrize("with_valid", [False, True], ids=["all", "valid"])
def test_norm_softmax_loss(with_valid):
    sim = _sim()
    valid = _valid() if with_valid else None
    want = jl.norm_softmax_loss(jnp.asarray(sim), 0.05,
                                None if valid is None else jnp.asarray(valid))
    got = tl.norm_softmax_loss(torch.from_numpy(sim), 0.05,
                               None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_norm_softmax_valid_equals_valid_rows_alone():
    sim, valid = _sim(), _valid()
    n = int(valid.sum())
    got = tl.norm_softmax_loss(torch.from_numpy(sim), 0.05, torch.from_numpy(valid))
    alone = tl.norm_softmax_loss(torch.from_numpy(sim[:n, :n]), 0.05)
    np.testing.assert_allclose(got.numpy(), alone.numpy(), **TOL)


def _local_inputs(b=6, r=5, w=7, d=16, seed=1):
    rng = np.random.RandomState(seed)
    im = rng.randn(b, r, d).astype(np.float32)
    s = rng.randn(b, w, d).astype(np.float32)
    im_mask = ((rng.rand(b, r) > 0.3).astype(np.float32) - 1.0) * 100.0
    s_mask = ((rng.rand(b, w) > 0.3).astype(np.float32) - 1.0) * 100.0
    im_mask[:, 0] = 0.0  # no fully masked item
    s_mask[:, 0] = 0.0
    return im, s, im_mask, s_mask


@pytest.mark.parametrize("focal", ["prob", "equal"])
@pytest.mark.parametrize("with_valid", [False, True], ids=["all", "valid"])
def test_rwa_loss(focal, with_valid):
    im, s, im_mask, s_mask = _local_inputs()
    valid = _valid(im.shape[0]) if with_valid else None
    want = jl.rwa_loss(jnp.asarray(im), jnp.asarray(s), jnp.asarray(im_mask),
                       jnp.asarray(s_mask), 20.0, focal,
                       valid=None if valid is None else jnp.asarray(valid))
    got = tl.rwa_loss(torch.from_numpy(im), torch.from_numpy(s), torch.from_numpy(im_mask),
                      torch.from_numpy(s_mask), 20.0, focal,
                      valid=None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOCAL_TOL)


@pytest.mark.parametrize(
    "args",
    [
        dict(focal_type="equal"),
        dict(focal_type="prob", temperature=0.07, lambda_softmax=10.0),
        dict(use_local=False),
        dict(use_global=False, focal_type="equal"),
    ],
    ids=["equal", "prob-t0.07-l10", "global-only", "local-only"],
)
def test_global_local_loss(args):
    im, s, im_mask, s_mask = _local_inputs()
    sim = _sim(im.shape[0], seed=2)
    lens = np.full(im.shape[0], s.shape[1] + 1, np.int32)
    want = jl.GlobalLocalLoss(coef=1000.0, **args)(
        jnp.asarray(sim), jnp.asarray(im), jnp.asarray(s), jnp.asarray(im_mask),
        jnp.asarray(lens), jnp.asarray(s_mask))
    got = tl.GlobalLocalLoss(coef=1000.0, **args)(
        torch.from_numpy(sim), torch.from_numpy(im), torch.from_numpy(s),
        torch.from_numpy(im_mask), torch.from_numpy(lens), torch.from_numpy(s_mask))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **LOCAL_TOL)
    # coef is never applied: the total is global + local
    np.testing.assert_allclose(got[0].numpy(), (got[1] + got[2]).numpy(), **TOL)


def test_local_dtype_bf16_runs_the_kernels_bf16_mode():
    """local_dtype 'bfloat16' reaches xattn_score_kernel's bf16 mode: on
    these inputs it differs from f32 by bf16 rounding only."""
    im, s, im_mask, s_mask = (torch.from_numpy(x) for x in _local_inputs())
    f32 = tl.RWALoss(focal_type="equal")(im, s, im_mask, None, s_mask)
    bf16 = tl.RWALoss(focal_type="equal", local_dtype="bfloat16")(im, s, im_mask, None, s_mask)
    assert float(f32) != float(bf16)
    np.testing.assert_allclose(bf16.numpy(), f32.numpy(), rtol=0.05)
    with pytest.raises(ValueError):
        tl.RWALoss(local_dtype="float16")


def test_xla_path_options_are_refused():
    for kw in (dict(local_block_segment=4), dict(local_remat=True)):
        with pytest.raises(NotImplementedError):
            tl.GlobalLocalLoss(**kw)
