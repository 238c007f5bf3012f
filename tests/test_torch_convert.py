"""Weights carried across: the port's own copy of the flax -> reference
torch mapping (demovlp_tpu_torch.convert.from_jax) against the JAX
package's exporter, and a reference-schema `.pth` loading strictly."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demovlp_tpu.convert.torch_export import (export_reference_state_dict,
                                              save_reference_checkpoint)
from demovlp_tpu.models import ObjectRelation as JaxObjectRelation
from demovlp_tpu.models.distilbert import DistilBertConfig as JaxTextConfig
from demovlp_tpu_torch.convert.from_jax import from_jax, load_reference_state_dict
from demovlp_tpu_torch.models import DistilBertConfig, ObjectRelation

TEXT = dict(vocab_size=256, dim=32, n_layers=2, n_heads=4, hidden_dim=64,
            max_position_embeddings=64)


def _pair(time_module):
    common = dict(object_num=4, num_frames=2, time_module=time_module,
                  projection_dim=16, object_embed_dim=32, object_depth=2,
                  object_heads=4)
    jm = JaxObjectRelation(text_config=JaxTextConfig(**TEXT), **common)
    batch = {
        "input_ids": jnp.ones((2, 8), jnp.int32),
        "attention_mask": jnp.ones((2, 8), jnp.int32),
        "object": jnp.zeros((2, 2, 4, 2054), jnp.float32),
        "object_mask": jnp.ones((2, 2, 4), jnp.float32),
    }
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), batch))
    tm = ObjectRelation(text_config=DistilBertConfig(**TEXT), **common)
    return params, tm


@pytest.mark.parametrize("time_module", [None, "timeattn"])
def test_from_jax_matches_export(time_module):
    params, tm = _pair(time_module)
    ref = export_reference_state_dict(params)
    got = from_jax(params)
    # the final norm always goes; norm3 goes only without a time module,
    # where the reference creates it but never applies it
    dropped = {k for k in ref if k.startswith("object_model.norm.")
               or (".norm3." in k and not time_module)}
    assert any(".norm3." in k for k in got) == bool(time_module)
    assert set(got) == set(ref) - dropped
    for k, v in got.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    tm.load_state_dict(got, strict=True)
    assert set(tm.state_dict()) == set(got)


@pytest.mark.parametrize("time_module", [None, "timeattn"])
def test_reference_pth_loads_strict(tmp_path, time_module):
    params, tm = _pair(time_module)
    path = tmp_path / "ref.pth"
    save_reference_checkpoint(str(path), params)
    sd = load_reference_state_dict(str(path))
    tm.load_state_dict(sd, strict=True)
    want = from_jax(params)
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)


def test_reference_pth_strips_dataparallel_prefix(tmp_path):
    params, tm = _pair(None)
    sd = {f"module.{k}": torch.from_numpy(v.copy())
          for k, v in export_reference_state_dict(params).items()}
    path = tmp_path / "dp.pth"
    torch.save({"state_dict": sd}, path)
    tm.load_state_dict(load_reference_state_dict(str(path)), strict=True)
