"""`precision.norm: "bfloat16"`: the towers' LayerNorms in bf16, against
the JAX package's `norm_dtype=jnp.bfloat16`, weights carried across by
demovlp_tpu_torch.convert.from_jax, on the CPU (dropout off).

The port takes the bf16 norm as flax does (models/layers.LayerNormFp32:
bf16 E[x], E[x^2], variance and rsqrt, the f32 scale and bias, one rounding
at the end), so the tests hold it much closer to flax's bf16 norm than the
port's f32 norm comes, and so tell the two apart. Readings on these inputs
(x86 CPU), as max |err| / max |want|:

* One LayerNorm (test_layer_norm_bf16_matches_flax): 0.0 for f32 and for
  bf16 input; the f32 norm rounded to bf16 reads 0.0085 / 0.0043. Held at
  1e-3.
* The towers at 2 layers each with f32 compute: at most 2.2e-5 over the
  outputs (summation order only); the f32-norm model reads 3.0e-3 at least
  on every output. Held at 2e-4 per output.
* The towers with bf16 compute, where the bf16 products' own differences
  (tests/test_torch_models.py) come on top: at most 0.0181 (held at 0.05)
  and elementwise |err| - 0.03 |want| at most 0.0519 (held at atol 0.15
  with rtol 0.03). Those limits alone would pass f32 norms too, so the
  case also holds the outputs' summed mean |err| / max |want| to 0.92 of
  the f32-norm model's (read 0.816 and 0.848); per output the ratio reads
  0.74-0.98, too close to 1 for a per-output margin.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demovlp_tpu.models import ObjectRelation as JaxObjectRelation
from demovlp_tpu.models.distilbert import DistilBertConfig as JaxTextConfig
from demovlp_tpu.models.layers import LayerNormFp32 as JaxLayerNorm
from demovlp_tpu_torch.cli import common
from demovlp_tpu_torch.convert.from_jax import from_jax
from demovlp_tpu_torch.models import DistilBertConfig, ObjectRelation
from demovlp_tpu_torch.models.layers import LayerNormFp32

TEXT = dict(vocab_size=512, dim=64, n_layers=2, n_heads=4, hidden_dim=128,
            max_position_embeddings=128)
LN_SCALED_MAX = 1e-3
F32_COMPUTE_SCALED_MAX = 2e-4
TOWER_SCALED_MAX = 0.05
TOWER_TOL = dict(rtol=3e-2, atol=1.5e-1)
BF16_COMPUTE_NEARER = 0.92


def test_layer_norm_bf16_matches_flax():
    rng = np.random.RandomState(0)
    x = (rng.randn(6, 9, 64) * 3 + 1.5).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    bias = (0.1 * rng.randn(64)).astype(np.float32)
    jln = JaxLayerNorm(epsilon=1e-6, dtype=jnp.bfloat16)
    params = {"params": {"LayerNorm_0": {"scale": scale, "bias": bias}}}
    ln = LayerNormFp32(64, eps=1e-6, compute_dtype=torch.bfloat16)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
    for in_dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        xt = torch.from_numpy(x).to(in_dtype)
        want = np.asarray(jln.apply(params, jnp.asarray(x).astype(jdtype)), np.float32)
        with torch.no_grad():
            got = ln(xt)
        assert got.dtype == in_dtype  # cast back to the input's dtype
        assert ln.weight.dtype == torch.float32  # parameters stay f32
        err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
        assert err <= LN_SCALED_MAX, (in_dtype, err)
        # the bf16 norm's result holds bf16 values even for an f32 input
        assert torch.equal(got.float(), got.to(torch.bfloat16).float())


def _models(compute: str, time_module):
    common_kw = dict(object_num=4, num_frames=2, time_module=time_module, projection_dim=16,
                     object_embed_dim=64, object_depth=2, object_heads=4)
    jm = JaxObjectRelation(text_config=JaxTextConfig(**TEXT), dtype=getattr(jnp, compute),
                           norm_dtype=jnp.bfloat16, **common_kw)
    tm = {nd: ObjectRelation(text_config=DistilBertConfig(**TEXT),
                             compute_dtype=getattr(torch, compute), norm_dtype=nd, **common_kw)
          for nd in (torch.bfloat16, torch.float32)}
    return jm, tm


def _batch(b=3, length=12, seed=0):
    rng = np.random.RandomState(seed)
    lens = rng.randint(3, length + 1, b)
    att = (np.arange(length)[None] < lens[:, None]).astype(np.int32)
    ids = rng.randint(1, TEXT["vocab_size"], (b, length)).astype(np.int32) * att
    mask = (rng.rand(b, 2, 4) > 0.3).astype(np.float32)
    mask[:, :, 0] = 1.0
    return {"input_ids": ids, "attention_mask": att,
            "object": rng.randn(b, 2, 4, 2054).astype(np.float32), "object_mask": mask}


@pytest.mark.parametrize("compute,time_module", [
    ("float32", None), ("float32", "timeattn"), ("bfloat16", None), ("bfloat16", "timeattn"),
], ids=["f32-compute", "f32-compute-timeattn", "bf16-compute", "bf16-compute-timeattn"])
def test_towers_match_jax(compute, time_module):
    jm, tm = _models(compute, time_module)
    batch = _batch()
    params = jm.init(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + 0.05 * rng.randn(*np.shape(x)).astype(np.float32),
        params)
    want = jm.apply(params, {k: jnp.asarray(v) for k, v in batch.items()}, deterministic=True)
    outs = {}
    for nd, model in tm.items():
        model.load_state_dict(from_jax(params), strict=True)
        with torch.no_grad():
            outs[nd] = model.eval()({k: torch.from_numpy(v) for k, v in batch.items()})
    got = outs[torch.bfloat16]
    err = {torch.bfloat16: 0.0, torch.float32: 0.0}  # summed mean |err| / max |want|
    for k in want:
        w = np.asarray(want[k], np.float32)
        g = got[k].float().numpy()
        assert got[k].dtype == (torch.float32 if k == "object_mask" else getattr(torch, compute))
        if k == "object_mask":
            np.testing.assert_array_equal(g, w)
            continue
        scale = np.abs(w).max()
        if compute == "float32":
            assert np.abs(g - w).max() <= F32_COMPUTE_SCALED_MAX * scale, k
        else:
            np.testing.assert_allclose(g, w, **TOWER_TOL)
            assert np.abs(g - w).max() <= TOWER_SCALED_MAX * scale, k
        for nd in err:
            err[nd] += np.abs(outs[nd][k].float().numpy() - w).mean() / scale
    # the bf16 norms come nearer flax's than the f32 norms do
    assert err[torch.bfloat16] <= BF16_COMPUTE_NEARER * err[torch.float32], err


def test_config_sets_the_norm_dtype_where_jax_does():
    """precision.norm reaches exactly the towers' norms: the embedding norm
    and both norms of each DistilBERT block, norm1 and norm2 (and norm3
    with time attention) of each region block; the MLM head's norm stays
    f32. A dtype the port has no mode for is refused by name."""
    cfg = {"precision": {"compute": "bfloat16", "norm": "bfloat16"},
           "arch": {"type": "ObjectRelation", "args": {
               "object_params": {"num_frames": 2, "object_num": 4, "time_module": "timeattn",
                                 "embed_dim": 32, "depth": 2, "heads": 4},
               "text_params": {"config": dict(TEXT, dim=32, hidden_dim=64)},
               "projection_dim": 16}},
           "mlm": {"weight": 0.5}}
    model = common.build_model(cfg)
    norms = {n: m.compute_dtype for n, m in model.named_modules()
             if isinstance(m, LayerNormFp32)}
    bf16 = sorted(n for n, d in norms.items() if d == torch.bfloat16)
    assert [n for n, d in norms.items() if d != torch.bfloat16] == ["mlm_head.vocab_layer_norm"]
    assert len(bf16) == (1 + 2 * 2) + 3 * 2
    assert common.norm_dtype({"precision": {}}) == torch.float32
    with pytest.raises(ValueError, match="precision.norm"):
        common.norm_dtype({"precision": {"norm": "float16"}})
