"""PatchRegionExtractor against the flax module, at tiny widths (embed 32,
depth 2, heads 2, patch 16, 32 x 32 frames, k = 3), the flax params carried
over by `extractor_from_jax`:

* f32: `object` and `conf` within 1e-5 of their largest |entry| (the
  products' summation order), the region indices (hence the geometry)
  identical;
* bf16: within 2e-2 of the largest |entry| (bf16 rounding of the blocks).
  At random init the saliency is near-uniform, so two confidences can lie
  within bf16 rounding of each other and swap slots: regions are matched
  by patch, each patch both sides selected held to 2e-2, and each slot's
  confidence too;
* constant frames with a zero position table (every patch tied): the
  indices lax.top_k gives, the lowest patches in order;
* the contract checks of tests/test_feature_extractor.py, and gradients
  reaching the extractor through the port's ObjectRelation, equal to the
  JAX package's within 1e-4 of the largest |entry| of all the extractor's
  gradients (f32; one scale, since the attention key biases' gradient is
  zero in exact arithmetic and rounding noise of order 1e-8 on both
  sides)."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demovlp_tpu.models import ObjectRelation as JaxObjectRelation
from demovlp_tpu.models import PatchRegionExtractor as JaxExtractor
from demovlp_tpu.models.distilbert import DistilBertConfig as JaxTextConfig
from demovlp_tpu_torch.convert.from_jax import extractor_from_jax, from_jax
from demovlp_tpu_torch.models import DistilBertConfig, ObjectRelation, PatchRegionExtractor

TINY = dict(object_num=3, patch=16, embed_dim=32, depth=2, heads=2)
DTYPES = {"f32": (torch.float32, jnp.float32, 1e-5), "bf16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _frames(b=2, f=2, h=32, w=32, seed=0):
    return np.random.RandomState(seed).rand(b, f, h, w, 3).astype(np.float32)


@functools.cache
def _jax_params(**kw):
    ex = JaxExtractor(**{**TINY, **kw})
    return jax.tree_util.tree_map(np.asarray, ex.init(jax.random.PRNGKey(0), _frames()))


def _pair(dtype="f32", **kw):
    tdt, jdt, _ = DTYPES[dtype]
    cfg = {**TINY, **kw}
    params = _jax_params(**kw)
    port = PatchRegionExtractor(**cfg, image_size=32, compute_dtype=tdt)
    port.load_state_dict(extractor_from_jax(params), strict=True)
    return JaxExtractor(**cfg, dtype=jdt), params, port


def _outputs(jax_model, params, port, frames):
    want = jax.jit(jax_model.apply)(params, frames)
    with torch.no_grad():
        got = port(torch.from_numpy(frames))
    return ({k: np.asarray(v, np.float32) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _patch(obj):
    """Patch index of each region from its geometry (x1, y1 on a 2 x 2 grid)."""
    return np.rint(obj[..., 2048] * 2 + obj[..., 2049] * 4).astype(int)


def test_f32_matches_flax():
    jm, params, port = _pair("f32")
    want, got = _outputs(jm, params, port, _frames())
    assert _rel(got["object"], want["object"]) < 1e-5
    assert _rel(got["conf"], want["conf"]) < 1e-5
    np.testing.assert_array_equal(got["object"][..., 2048:], want["object"][..., 2048:])
    np.testing.assert_array_equal(got["object_mask"], want["object_mask"])
    assert got["object"].dtype == got["conf"].dtype == np.float32


def test_bf16_matches_flax_up_to_near_ties():
    jm, params, port = _pair("bf16")
    want, got = _outputs(jm, params, port, _frames())
    assert _rel(got["conf"], want["conf"]) < 2e-2
    scale = float(np.abs(want["object"]).max())
    gp, wp = _patch(got["object"]), _patch(want["object"])
    matched = 0
    for frame in np.ndindex(gp.shape[:2]):
        for slot, patch in enumerate(gp[frame]):
            hits = np.flatnonzero(wp[frame] == patch)
            if hits.size:
                diff = np.abs(got["object"][frame][slot] - want["object"][frame][hits[0]]).max()
                assert diff / scale < 2e-2, (frame, patch, diff / scale)
                matched += 1
    # 3 of 4 patches each side: at least 2 common a frame
    assert matched >= 2 * gp.shape[0] * gp.shape[1]


def test_ties_keep_the_lowest_patches_first():
    """Constant frames and a zero position table: every patch token is the
    same, so every confidence is the same."""
    jm, params, port = _pair("f32")
    params = jax.tree_util.tree_map(lambda x: x, params)
    params["params"] = dict(params["params"], pos_embed=np.zeros_like(params["params"]["pos_embed"]))
    port.load_state_dict(extractor_from_jax(params), strict=True)
    frames = np.full((1, 2, 32, 32, 3), 0.5, np.float32)
    want, got = _outputs(jm, params, port, frames)
    assert np.all(want["conf"] == want["conf"][..., :1])
    np.testing.assert_array_equal(_patch(want["object"]), [[[0, 1, 2], [0, 1, 2]]])
    np.testing.assert_array_equal(got["object"][..., 2048:], want["object"][..., 2048:])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_contract(dtype):
    _, _, port = _pair(dtype)
    with torch.no_grad():
        out = port(torch.from_numpy(_frames()))
    assert out["object"].shape == (2, 2, 3, 2054)
    assert out["object_mask"].shape == (2, 2, 3)
    conf = out["conf"].numpy()
    assert (np.diff(conf, axis=-1) <= 1e-6).all()
    geom = out["object"][..., 2048:].numpy()
    assert geom.min() >= 0.0 and geom.max() <= 1.0
    assert np.allclose(geom[..., 2] - geom[..., 0], geom[..., 4], atol=1e-6)


def test_gradients_reach_the_extractor_through_object_relation():
    text = dict(vocab_size=300, dim=32, n_layers=1, n_heads=4, hidden_dim=64,
                max_position_embeddings=32)
    common = dict(object_num=4, num_frames=2, projection_dim=8, object_embed_dim=32,
                  object_depth=1, object_heads=4)
    jm, ex_params, port_ex = _pair("f32", object_num=4)
    jax_model = JaxObjectRelation(text_config=JaxTextConfig(**text), **common)
    frames = _frames()
    rng = np.random.RandomState(1)
    txt = {"input_ids": rng.randint(1, 300, size=(2, 16)).astype(np.int32),
           "attention_mask": np.ones((2, 16), np.int32)}
    regions = jax.jit(jm.apply)(ex_params, frames)
    m_params = jax.tree_util.tree_map(np.asarray, jax_model.init(
        jax.random.PRNGKey(1), {**txt, "object": regions["object"],
                                "object_mask": regions["object_mask"]}))

    def jax_loss(ep):
        r = jm.apply(ep, frames)
        out = jax_model.apply(m_params, {**txt, "object": r["object"],
                                         "object_mask": r["object_mask"]}, deterministic=True)
        return jnp.sum(out["global_object_embeddings"] ** 2)

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(ex_params)
    want = extractor_from_jax(jax.tree_util.tree_map(np.asarray, want_grads))

    model = ObjectRelation(text_config=DistilBertConfig(**text), **common).eval()
    model.load_state_dict(from_jax(m_params), strict=True)
    r = port_ex(torch.from_numpy(frames))
    out = model({"input_ids": torch.from_numpy(txt["input_ids"]).long(),
                 "attention_mask": torch.from_numpy(txt["attention_mask"]).long(),
                 "object": r["object"], "object_mask": r["object_mask"]})
    loss = torch.sum(out["global_object_embeddings"] ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    grads = dict(port_ex.named_parameters())
    scale = max(float(g.abs().max()) for g in want.values())
    total = 0.0
    for key, g_want in want.items():
        g = grads[key].grad
        if g is None:  # the saliency query moves the selection, not the values
            assert not g_want.any(), key
            continue
        assert bool(torch.isfinite(g).all()), key
        total += float(g.abs().sum())
        assert float((g - g_want).abs().max()) / scale < 1e-4, key
        if key.endswith("attn.key.bias"):  # zero in exact arithmetic: a softmax ignores a shift
            assert float(g.abs().max()) / scale < 1e-5, key
    assert total > 0


def test_reset_parameters_follows_the_flax_initialisers():
    a = PatchRegionExtractor(**TINY, image_size=32)
    b = PatchRegionExtractor(**TINY, image_size=32)
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    sd_a, sd_b = a.state_dict(), b.state_dict()
    assert set(sd_a) == set(extractor_from_jax(_jax_params()))
    for key, value in sd_a.items():
        assert torch.equal(value, sd_b[key]), key
        if key.endswith("bias"):
            assert not value.any(), key
    for key in ("block_0.norm1.weight", "block_1.norm2.weight", "norm.weight"):
        assert bool((sd_a[key] == 1).all()), key
    for key in ("pos_embed", "saliency_query"):
        assert float(sd_a[key].abs().max()) <= 0.04 and float(sd_a[key].abs().max()) > 0
    bound = 2 / np.sqrt(3 * 16 * 16) / 0.87962566
    assert float(sd_a["stem.weight"].abs().max()) <= bound + 1e-7
