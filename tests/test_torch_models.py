"""The port's towers and ObjectRelation against the JAX package's
`model.apply`, with the same weights carried across by
demovlp_tpu_torch.convert.from_jax (dropout off: serving is deterministic).

Tolerances. f32: rtol 1e-4, atol 1e-5 — both sides compute in f32 and
differ only in summation order (and flax's E[x^2]-E[x]^2 LayerNorm
variance against torch's two-pass form).

bf16 compute: the frameworks round to bf16 at different places (flax adds
the Dense bias after rounding the product, torch fuses it; GELU and the
1/sqrt(hd) scale round differently), and one bf16 rounding is 2^-8 = 0.4%
relative, so two layers of such differences reach a few bf16 ulps.
Measured on test_object_relation_bf16's inputs (x86 CPU, float32 numpy
comparison): max |err| / max |want| per output is 0.0091 (global object),
0.0109 (global text), 0.0064 (local object), 0.0101 (local text); the
largest |err| - 0.02 |want| is 0.035. The bounds are about 2.3x those
readings: 0.025 of each output's largest value, and elementwise
atol 0.08 with rtol 0.02. At this size such bounds hold the structure
(the right ops, weights, masks and output dtypes), not the place of each
bf16 rounding: one rounding moved elsewhere (bf16 attention logits, say)
shifts these readings by about as much as the frameworks' own
differences do.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demovlp_tpu.models import ObjectRelation as JaxObjectRelation
from demovlp_tpu.models.distilbert import DistilBertConfig as JaxTextConfig
from demovlp_tpu.models.distilbert import DistilBertModel as JaxDistilBert
from demovlp_tpu.models.object_transformer import ObjectTransformer as JaxObjectTransformer
from demovlp_tpu_torch.convert.from_jax import from_jax
from demovlp_tpu_torch.models import DistilBertConfig, ObjectRelation

TEXT = dict(vocab_size=512, dim=32, n_layers=2, n_heads=4, hidden_dim=64,
            max_position_embeddings=128)
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=8e-2)
BF16_SCALED_MAX = 0.025  # max |err| / max |want| per output


def _models(frames, regions, attn_impl="dense", time_module=None, dtype="float32"):
    common = dict(object_num=regions, num_frames=frames, time_module=time_module,
                  projection_dim=16, object_embed_dim=32, object_depth=2,
                  object_heads=4, attn_impl=attn_impl)
    jm = JaxObjectRelation(text_config=JaxTextConfig(**TEXT),
                           dtype=getattr(jnp, dtype), **common)
    tm = ObjectRelation(text_config=DistilBertConfig(**TEXT),
                        compute_dtype=getattr(torch, dtype), **common)
    return jm, tm


def _batch(frames, regions, b=3, length=12, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, TEXT["vocab_size"], (b, length)).astype(np.int32)
    lens = rng.randint(3, length + 1, b)
    att = (np.arange(length)[None] < lens[:, None]).astype(np.int32)
    ids = ids * att
    obj = rng.randn(b, frames, regions, 2054).astype(np.float32)
    obj_mask = (rng.rand(b, frames, regions) > 0.3).astype(np.float32)
    obj_mask[:, :, 0] = 1.0
    return {"input_ids": ids, "attention_mask": att, "object": obj,
            "object_mask": obj_mask}


def _params(jm, batch, seed=1):
    """JAX init, then every leaf perturbed so biases, LayerNorms and the
    temporal embed are non-trivial."""
    params = jm.init(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rng.randn(*np.shape(x)).astype(np.float32),
        params,
    )


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port(tm, params):
    tm.load_state_dict(from_jax(params), strict=True)
    return tm.eval()


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float().detach().numpy(), np.float32),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize(
    "frames,regions,attn_impl,time_module",
    [
        (2, 4, "dense", None),
        (2, 4, "xla", None),
        (2, 4, "dense", "timeattn"),
        (2, 4, "xla", "timeattn"),
        (1, 30, "dense", None),  # single-group fast path
        (1, 30, "xla", "timeattn"),
    ],
)
def test_object_relation_f32(frames, regions, attn_impl, time_module):
    jm, tm = _models(frames, regions, attn_impl, time_module)
    batch = _batch(frames, regions)
    params = _params(jm, batch)
    tm = _port(tm, params)
    want = jm.apply(params, {k: jnp.asarray(v) for k, v in batch.items()},
                    deterministic=True)
    with torch.no_grad():
        got = tm(_torch_batch(batch))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        _close(got[k], want[k], F32_TOL)


def test_distilbert_f32():
    jm, tm = _models(2, 4)
    batch = _batch(2, 4, seed=2)
    params = _params(jm, batch)
    tm = _port(tm, params)
    jtext = JaxDistilBert(JaxTextConfig(**TEXT))
    want = jtext.apply({"params": params["params"]["text_tower"]["text_model"]},
                       jnp.asarray(batch["input_ids"]),
                       jnp.asarray(batch["attention_mask"]), True)
    with torch.no_grad():
        got = tm.text_model(torch.from_numpy(batch["input_ids"]),
                            torch.from_numpy(batch["attention_mask"]))
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("attn_impl", ["dense", "xla"])
def test_object_transformer_f32(attn_impl):
    jm, tm = _models(2, 4, attn_impl, "timeattn")
    batch = _batch(2, 4, seed=3)
    params = _params(jm, batch)
    tm = _port(tm, params)
    jot = JaxObjectTransformer(region_nums=4, num_frames=2, output_dim=16,
                               time_module="timeattn", embed_dim=32, depth=2,
                               num_heads=4, attn_impl=attn_impl)
    want, want_mask = jot.apply(
        {"params": params["params"]["object_model"]},
        jnp.asarray(batch["object"]), jnp.asarray(batch["object_mask"]), True,
    )
    with torch.no_grad():
        got, got_mask = tm.object_model(torch.from_numpy(batch["object"]),
                                        torch.from_numpy(batch["object_mask"]))
    _close(got, want, F32_TOL)
    _close(got_mask, want_mask, dict(rtol=0, atol=0))


def test_object_relation_bf16():
    jm, tm = _models(2, 4, "dense", None, dtype="bfloat16")
    batch = _batch(2, 4, seed=4)
    params = _params(jm, batch)
    tm = _port(tm, params)
    want = jm.apply(params, {k: jnp.asarray(v) for k, v in batch.items()},
                    deterministic=True)
    with torch.no_grad():
        got = tm(_torch_batch(batch))
    for k in want:
        assert got[k].dtype == (torch.float32 if k == "object_mask" else torch.bfloat16), k
        _close(got[k], want[k], BF16_TOL)
        g = got[k].float().numpy()
        w = np.asarray(want[k], np.float32)
        assert np.abs(g - w).max() <= BF16_SCALED_MAX * np.abs(w).max(), k
