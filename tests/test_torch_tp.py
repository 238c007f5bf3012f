"""Tensor parallelism (parallel/tp.py) on the CPU.

* The plan's placements against JAX `tp_spec` on the same weights: the
  JAX model's parameter tree, each leaf replaced by a code of its spec,
  goes through `from_jax`, so every port key carries the JAX placement of
  its leaf (a column kernel P(None, model) is a Shard(0) weight, a column
  bias P(model) a Shard(0) bias, a row kernel P(model, None) a Shard(1)
  weight). At model size 2 everything divides; at model size 4 with a
  text FFN of width 66 that FFN falls back to replicated in both.
* One train step on two gloo processes at mesh (1, 2) (each killed after
  120 s), both ranks feeding the whole batch, against the one-process
  step: the loss within 1e-5 relative, every gradient (gathered whole)
  and updated parameter within 1e-4 of its tensor's largest |value| +
  1e-6, as tests/test_torch_dist.py holds data parallelism (the step
  clips at `max_grad_norm`, so the norm of the split gradient is checked
  too); the placements the ranks report are the plan's.
* A TP checkpoint: rank 0 writes the whole reference-layout state dict,
  which loads strictly into a model with no TP and equals the TP model's
  weights; both ranks restore it and step on identically.
"""
from __future__ import annotations

import os

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor.parallel import RowwiseParallel

from demovlp_tpu.models import ObjectRelation as JaxObjectRelation
from demovlp_tpu.models.distilbert import DistilBertConfig as JaxTextConfig
from demovlp_tpu.parallel.tp import tp_spec
from demovlp_tpu_torch.cli.common import build_optimizer
from demovlp_tpu_torch.convert.from_jax import from_jax
from demovlp_tpu_torch.parallel.tp import qkv_permutation, tp_plan
from demovlp_tpu_torch.train.steps import make_retrieval_train_step
from tests import torch_dist_worker as W
from tests.test_torch_dist import close_tensors

# spec codes: replicated, column kernel, row kernel, column bias
_CODES = {(): "R", (None, "model"): "S0", ("model", None): "S1", ("model",): "S0"}
_TORCH = {"R": "R", "S(0)": "S0", "S(1)": "S1"}


def _jax_placements(hidden: int, m: int):
    cfg = dict(W.TEXT, hidden_dim=hidden)
    cfg.pop("dropout"), cfg.pop("attention_dropout")
    model = JaxObjectRelation(object_num=W.K, num_frames=W.F, time_module="timeattn",
                              projection_dim=16, text_config=JaxTextConfig(**cfg),
                              object_embed_dim=32, object_depth=2, object_heads=4)
    batch = {k: v[:2] for k, v in W.make_batch(0).items()}
    params = model.init(jax.random.PRNGKey(0), batch)
    names = list(_CODES.values())
    codes = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(leaf.shape, list(_CODES).index(tuple(tp_spec(path, leaf, m))),
                                   np.float32), params)
    out = {}
    for key, t in from_jax(codes).items():
        assert float(t.min()) == float(t.max()), key
        out[key] = names[int(t.reshape(-1)[0])]
    return out


def plan_placements(model, m: int):
    """{state key: R / S0 / S1} as the plan lays the model out."""
    out = {k: "R" for k in model.state_dict()}
    for path, style in tp_plan(model, m).items():
        row = isinstance(style, RowwiseParallel)
        out[f"{path}.weight"] = "S1" if row else "S0"
        if not row:
            out[f"{path}.bias"] = "S0"
    return out


@pytest.mark.parametrize("hidden,m", [(64, 2), (66, 4)], ids=["divides", "ffn-replicated"])
def test_plan_matches_jax_tp_spec(hidden, m):
    want = _jax_placements(hidden, m)
    got = plan_placements(W.tiny_model(hidden=hidden), m)
    assert got == want
    assert sum(v != "R" for v in got.values()) > 0
    ffn = "text_model.transformer.layer.0.ffn.lin1.weight"
    assert got[ffn] == ("S0" if hidden % m == 0 else "R")
    # the towers' final projections stay replicated
    assert got["object_model.proj.weight"] == got["txt_proj.1.weight"] == "R"
    assert got["object_model.blocks.0.attn.proj.weight"] == "S1"


def test_plan_is_empty_at_one_rank():
    assert tp_plan(W.tiny_model(), 1) == {}


def test_qkv_permutation_groups_each_ranks_heads():
    perm = qkv_permutation(12, 2).tolist()  # D = 4: q 0-3, k 4-7, v 8-11
    assert perm == [0, 1, 4, 5, 8, 9, 2, 3, 6, 7, 10, 11]


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp"))
    init = {"retrieval": W.tiny_model().state_dict()}
    W.spawn(W.tp_case, 2, out, init)
    return init, [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                  for r in (0, 1)]


def test_tp_step_matches_one_process(tp_run):
    init, ranks = tp_run
    model = W.tiny_model()
    model.load_state_dict(init["retrieval"])
    opt = build_optimizer({"optimizer": {"type": "AdamW",
                                         "args": {"lr": 1e-3, "max_grad_norm": 0.05}}},
                          model.parameters())
    m = make_retrieval_train_step(model, W.loss_obj(), opt, deterministic=True)(
        W.to_torch(W.make_batch(1)), 1e-3)
    grads = {n: p.grad for n, p in model.named_parameters()}
    params = {n: p.detach() for n, p in model.named_parameters()}
    want = plan_placements(model, 2)
    for r in ranks:
        for k, v in m.items():
            np.testing.assert_allclose(r["metrics"][k], float(v), rtol=1e-5, atol=1e-6, err_msg=k)
        close_tensors(grads, r["grads"])
        close_tensors(params, r["params"])
        got = {n: _TORCH[pl[0]] if pl else "R" for n, pl in r["placements"].items()}
        assert got == {n: want[n] for n in got}


def test_tp_checkpoint_loads_without_tp(tmp_path):
    init = {"retrieval": W.tiny_model().state_dict()}
    W.spawn(W.checkpoint_case, 2, str(tmp_path), init, 2)
    ckpt = torch.load(tmp_path / "ckpt" / "checkpoint-epoch1.pth", weights_only=True)
    plain = W.tiny_model()
    plain.load_state_dict(ckpt["state_dict"], strict=True)
    for r in (torch.load(tmp_path / f"rank{i}.pt", weights_only=False) for i in (0, 1)):
        for k, v in plain.state_dict().items():
            assert torch.equal(r["saved"][k], v), k
            assert torch.equal(r["restored"][k], v), k
        assert r["resumed"] == r["live"] and (r["epoch"], r["count"]) == (1, 2)
        for k, v in r["live_params"].items():
            assert torch.equal(r["resumed_params"][k], v), k
    # the moments were written whole: a plain optimizer takes them
    opt = build_optimizer({"optimizer": {"type": "AdamW", "args": {"lr": 1e-3}}},
                          plain.parameters())
    opt.load_state_dict(ckpt["optimizer"])
    for p in plain.parameters():
        assert opt.state[p]["mu"].shape == p.shape
