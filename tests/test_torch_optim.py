"""The port's AdamW and epoch schedule against the JAX package's
`make_optimizer` (optax.adamw, or the reference_exact transformers form) and
`step_decay_lr`: five steps on a random parameter tree with the same
gradients, fed to both as numpy.

Tolerance: rtol 1e-6 / atol 1e-9 on the parameters after five steps, which
are f32 on both sides and differ only in where the scalars round (the
update is lr-scaled, so an ulp of the step is far under atol). Under
mu_dtype bfloat16 both store the first moment in bf16, rounded at the same
places; a last-bit difference in b1 * m can flip that rounding, moving an
update by 2^-8 of lr at most, so those runs are held at atol 2^-8 * lr.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from demovlp_tpu.train.optim import make_optimizer as jax_make_optimizer
from demovlp_tpu.train.optim import step_decay_lr as jax_step_decay_lr
from demovlp_tpu_torch.train.optim import AdamW, step_decay_lr

SHAPES = {"w": (7, 5), "b": (5,), "emb": (11, 3), "scale": (1,)}
LR = 1e-3


def _run_both(steps: int = 5, grad_scale: float = 1.0, **kw):
    rng = np.random.RandomState(0)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (grad_scale * rng.randn(*s)).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(steps)]
    grads[1]["b"][:] = 0.0  # a step with an all-zero leaf

    tx = jax_make_optimizer(lr=LR, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    for g in grads:
        state.hyperparams["learning_rate"] = jnp.asarray(LR, jnp.float32)
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = AdamW(list(tp.values()), lr=LR, **kw)
    for g in grads:
        opt.set_lr(LR)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    return {k: np.asarray(v) for k, v in jp.items()}, {k: v.detach().numpy() for k, v in tp.items()}


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"reference_exact": True},
        {"weight_decay": 0.05},
        {"weight_decay": 0.05, "reference_exact": True},
        {"max_grad_norm": 1.0},
        {"max_grad_norm": 1.0, "reference_exact": True, "weight_decay": 0.01},
        {"mu_dtype": "bfloat16"},
        {"mu_dtype": "bfloat16", "reference_exact": True},
        {"pack_small": True, "eps": 1e-8, "b1": 0.8, "b2": 0.99},
    ],
    ids=["optax", "reference_exact", "wd", "wd-reference_exact", "clip",
         "clip-reference_exact-wd", "mu_bf16", "mu_bf16-reference_exact", "pack_small-betas"],
)
def test_five_steps_match_jax(kw):
    want, got = _run_both(**kw)
    atol = 2.0**-8 * LR if kw.get("mu_dtype") else 1e-9
    for k in SHAPES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=atol, err_msg=k)


def test_clipping_engages_and_stays_off_below_the_limit():
    """The global norm of these gradients is about 7.5: a limit of 1 clips
    every step; a limit of 100 leaves the run equal to the unclipped one."""
    clipped, _ = _run_both(max_grad_norm=1.0, grad_scale=10.0, steps=2)
    plain, _ = _run_both(grad_scale=10.0, steps=2)
    assert any(not np.allclose(clipped[k], plain[k]) for k in SHAPES)
    _, got_high = _run_both(max_grad_norm=100.0, steps=2)
    _, got_none = _run_both(steps=2)
    for k in SHAPES:
        np.testing.assert_array_equal(got_high[k], got_none[k])


def test_defaults_are_the_jax_packages_not_torchs():
    opt = AdamW([torch.nn.Parameter(torch.zeros(2))])
    group = opt.param_groups[0]
    assert (group["eps"], group["weight_decay"], group["b1"], group["b2"]) == (
        1e-6, 0.0, 0.9, 0.999)


@pytest.mark.parametrize("lr_mode", ["reference", "config"])
def test_step_decay_lr_matches_jax(lr_mode):
    for epoch in range(1, 46):
        for milestones in ([30, 40], [2, 5, 9], []):
            assert step_decay_lr(epoch, 1e-4, 2e-4, milestones, lr_mode) == \
                jax_step_decay_lr(epoch, 1e-4, 2e-4, milestones, lr_mode)
