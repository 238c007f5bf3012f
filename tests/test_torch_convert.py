"""Weights carried across: the port's own copy of the flax -> reference
torch mapping (demovlp_tpu_torch.convert.from_jax) against the JAX
package's exporter, a reference-schema `.pth` loading strictly, and the
temporal-embed inflation (demovlp_tpu_torch.convert.torch_import) against
demovlp_tpu.convert.torch_import: the function itself, and an f = 1
checkpoint starting an f = 8 model, tensor for tensor equal to the JAX
loader's result."""
from __future__ import annotations

import json
from pathlib import Path

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

ROOT = Path(__file__).resolve().parents[1]
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


# ---- temporal-embed inflation and loading a checkpoint at another frame count

@pytest.mark.parametrize("mode", ["zeros", "interp", "bilinear"])
@pytest.mark.parametrize("frames", [(1, 8), (3, 8), (2, 5), (4, 4), (8, 3)],
                         ids=["1to8", "3to8", "2to5", "same", "truncate"])
def test_inflate_temporal_embed_matches_jax(mode, frames):
    from demovlp_tpu.convert.torch_import import inflate_temporal_embed as jax_inflate
    from demovlp_tpu_torch.convert.torch_import import inflate_temporal_embed

    f_load, f_target = frames
    embed = np.random.RandomState(f_load).randn(1, f_load, 6).astype(np.float32)
    want = jax_inflate(embed, f_target, mode)
    got = inflate_temporal_embed(embed, f_target, mode)
    assert got.shape == (1, f_target, 6) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _jax_model(num_frames, qa=False):
    from demovlp_tpu.models import ObjectQARelation as JaxQA

    common = dict(object_num=4, num_frames=num_frames, projection_dim=16,
                  object_embed_dim=32, object_depth=2, object_heads=4)
    cls = JaxQA if qa else JaxObjectRelation
    jm = cls(text_config=JaxTextConfig(**TEXT), **common)
    batch = {
        "input_ids": jnp.ones((2, 8), jnp.int32),
        "attention_mask": jnp.ones((2, 8), jnp.int32),
        "object": jnp.zeros((2, num_frames, 4, 2054), jnp.float32),
        "object_mask": jnp.ones((2, num_frames, 4), jnp.float32),
    }
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1), batch))
    # a trained embed is not zero: give every frame its own row
    tower = params["params"]["object_model"]
    tower["temporal_embed"] = np.random.RandomState(9).randn(
        *tower["temporal_embed"].shape).astype(np.float32)
    return params, common


@pytest.mark.parametrize("mode", ["zeros", "interp", "bilinear"])
def test_f1_checkpoint_starts_an_f8_model_as_the_jax_loader_does(tmp_path, mode):
    """A reference-schema f = 1 checkpoint (DataParallel prefix included)
    loaded through build_train_model into an f = 8 model: every tensor
    equals what the JAX loader (`load_reference_checkpoint` with
    `temporal_fix`) gives."""
    from demovlp_tpu.convert import load_reference_checkpoint
    from demovlp_tpu_torch.cli.common import build_train_model

    params, _ = _jax_model(1)
    sd = {f"module.{k}": torch.from_numpy(v.copy())
          for k, v in export_reference_state_dict(params).items()}
    path = tmp_path / "f1.pth"
    torch.save({"state_dict": sd}, path)
    cfg = json.loads((ROOT / "configs" / "smoke" / "synthetic_retrieval.json").read_text())
    args = cfg["arch"]["args"]
    args["object_params"].update(num_frames=8, object_num=4, embed_dim=32)
    args["text_params"]["config"].update(vocab_size=256, max_position_embeddings=64)
    args.update(load_checkpoint=str(path), load_temporal_fix=mode)
    model = build_train_model(cfg, torch.device("cpu"), seed=3)
    want = from_jax(jax.tree_util.tree_map(np.asarray, load_reference_checkpoint(
        str(path), num_frames=8, depth=2, n_text_layers=2, temporal_fix=mode)))
    got = model.state_dict()
    assert set(got) == set(want)
    assert got["object_model.temporal_embed"].shape == (1, 8, 32)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)


def test_qa_checkpoint_loads_strictly(tmp_path):
    """A QA checkpoint (towers and BUTD head) loads into the port's QA model
    tensor for tensor; a retrieval checkpoint, which has no head, and a
    checkpoint missing any other key raise."""
    from demovlp_tpu_torch.convert.torch_import import load_pretrained
    from demovlp_tpu_torch.models import ObjectQARelation

    params, common = _jax_model(2, qa=True)
    path = tmp_path / "qa.pth"
    save_reference_checkpoint(str(path), params)
    tm = ObjectQARelation(text_config=DistilBertConfig(**TEXT), **common)
    load_pretrained(tm, str(path), num_frames=2)
    want = from_jax(params)
    assert any(k.startswith("head.") for k in want)
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    ret, _ = _jax_model(2)
    save_reference_checkpoint(str(tmp_path / "ret.pth"), ret)
    with pytest.raises(RuntimeError, match="head.classifier"):
        load_pretrained(tm, str(tmp_path / "ret.pth"), num_frames=2)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    del sd["state_dict"]["txt_proj.1.bias"]
    torch.save(sd, tmp_path / "bad.pth")
    with pytest.raises(RuntimeError, match="txt_proj.1.bias"):
        load_pretrained(tm, str(tmp_path / "bad.pth"), num_frames=2)
