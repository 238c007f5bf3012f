"""`import_timm_vit` on a random state dict in timm's ViT key schema, at the
tiny geometry of tests/test_convert.py: the JAX package's import followed
by `from_jax` equals the port's import on `from_jax` of the same params,
key for key, exactly; keys outside cls_token and the blocks keep their
values; blocks the timm dict lacks keep theirs; the result loads strictly
into the port's model."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demovlp_tpu.convert import import_timm_vit as jax_import_timm_vit
from demovlp_tpu.models import ObjectRelation as JaxObjectRelation
from demovlp_tpu.models.distilbert import DistilBertConfig as JaxTextConfig
from demovlp_tpu_torch.convert.from_jax import from_jax
from demovlp_tpu_torch.convert.torch_import import import_timm_vit
from demovlp_tpu_torch.models import DistilBertConfig, ObjectRelation

TEXT = dict(vocab_size=128, dim=32, n_layers=2, n_heads=4, hidden_dim=64,
            max_position_embeddings=64)
D_OBJ, DEPTH, H_OBJ, PROJ, K, F = 32, 2, 4, 16, 4, 2


def _common(time_module):
    return dict(object_num=K, num_frames=F, time_module=time_module, projection_dim=PROJ,
                object_embed_dim=D_OBJ, object_depth=DEPTH, object_heads=H_OBJ)


@functools.cache
def _jax_params(time_module):
    """The flax model's params (numpy leaves; every reader copies them)."""
    model = JaxObjectRelation(text_config=JaxTextConfig(**TEXT), **_common(time_module))
    batch = {"input_ids": jnp.ones((2, 8), jnp.int32),
             "attention_mask": jnp.ones((2, 8), jnp.int32),
             "object": jnp.zeros((2, F, K, 2054), jnp.float32),
             "object_mask": jnp.ones((2, F, K), jnp.float32)}
    return jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(0), batch))


def _params(time_module):
    port = ObjectRelation(text_config=DistilBertConfig(**TEXT), **_common(time_module))
    return _jax_params(time_module), port


def _timm(blocks, seed=2):
    rng = np.random.RandomState(seed)
    sd = {"cls_token": rng.randn(1, 1, D_OBJ).astype(np.float32),
          # keys the import never reads (timm's embeddings and head)
          "pos_embed": rng.randn(1, 197, D_OBJ).astype(np.float32),
          "patch_embed.proj.weight": rng.randn(D_OBJ, 3, 16, 16).astype(np.float32),
          "head.weight": rng.randn(10, D_OBJ).astype(np.float32)}
    shapes = {"norm1": (D_OBJ,), "norm2": (D_OBJ,), "attn.qkv": (3 * D_OBJ, D_OBJ),
              "attn.proj": (D_OBJ, D_OBJ), "mlp.fc1": (4 * D_OBJ, D_OBJ),
              "mlp.fc2": (D_OBJ, 4 * D_OBJ)}
    for i in blocks:
        for name, shape in shapes.items():
            sd[f"blocks.{i}.{name}.weight"] = rng.randn(*shape).astype(np.float32)
            sd[f"blocks.{i}.{name}.bias"] = rng.randn(shape[0]).astype(np.float32)
    return sd


@pytest.mark.parametrize("time_module", [None, "timeattn"])
@pytest.mark.parametrize("blocks", [(0, 1), (0,), (1,)])
def test_import_matches_jax(time_module, blocks):
    params, port = _params(time_module)
    vit = _timm(blocks)
    want = from_jax(jax_import_timm_vit(vit, params, depth=DEPTH))
    start = from_jax(params)
    got = import_timm_vit(vit, start, depth=DEPTH)
    assert set(got) == set(want) == set(start)
    for key, value in got.items():
        assert value.dtype == torch.float32
        np.testing.assert_array_equal(value.numpy(), want[key].numpy(), err_msg=key)
    imported = {"object_model.cls_token"} | {
        key for key in start for i in blocks
        if key.startswith(f"object_model.blocks.{i}.") and ".timeattn." not in key
        and ".norm3." not in key}
    assert len(imported) == 1 + 12 * len(blocks)
    for key in start:
        if key in imported:
            assert not torch.equal(got[key], start[key]), key
        else:
            assert torch.equal(got[key], start[key]), key
    port.load_state_dict(got, strict=True)


def test_import_takes_tensors_and_leaves_its_inputs_alone():
    params, _ = _params(None)
    vit = _timm((0, 1))
    start = from_jax(params)
    before = {k: v.clone() for k, v in start.items()}
    from_arrays = import_timm_vit(vit, start, depth=DEPTH)
    from_tensors = import_timm_vit({k: torch.from_numpy(v) for k, v in vit.items()}, start,
                                   depth=DEPTH)
    for key in from_arrays:
        assert torch.equal(from_arrays[key], from_tensors[key]), key
        assert torch.equal(start[key], before[key]), key


def test_a_timm_block_beyond_the_tower_is_refused():
    params, _ = _params(None)
    with pytest.raises(KeyError, match="blocks.2"):
        import_timm_vit(_timm((0, 1, 2)), from_jax(params), depth=3)
