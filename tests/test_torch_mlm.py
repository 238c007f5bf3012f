"""The MLM pre-training objective (`mlm.weight` > 0), on the CPU, against the
JAX package: configs/smoke/synthetic_retrieval.json with `mlm.weight` 0.5
and `trainer.text_buckets` [16, 32], f32, the JAX ObjectRelation (with
its MLM head) carried across with `from_jax`.

* `mask_batch_text_tokens` is bit-identical to the JAX one under the same
  Generator state.
* The MLM head: the model's `mlm_logits` against the JAX model's, rtol 1e-4
  / atol 1e-5 (f32 towers, summation order, as tests/test_torch_models.py
  holds the towers); `from_jax` carries the head under Hugging Face's
  names and the state dict loads strictly with and without it.
* `mlm_loss_fn` against the JAX one, rtol 1e-6.
* Two deterministic train steps: the port's RetrievalTrainer masks its
  bucketed train batches with `default_rng(seed + 1)` as the JAX trainer
  does (identical ids and labels), and the port's step against the JAX
  train step's body (`make_retrieval_train_step` with `mlm_weight` 0.5:
  the losses, their gradients, one AdamW update) on them gives the losses
  (mlm_loss included) at tests/test_torch_train.py's LOSS_TOL and step-1
  gradients at its GRAD_TOL.
* Eval and serving never run the head.
"""
from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from demovlp_tpu.cli import common as jcommon
from demovlp_tpu.config import ConfigParser as JaxConfig
from demovlp_tpu.data.mlm import mask_batch_text_tokens as jax_mask
from demovlp_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer
from demovlp_tpu.train.state import TrainState
from demovlp_tpu.train.steps import _retrieval_losses
from demovlp_tpu.train.steps import mlm_loss_fn as jax_mlm_loss
from demovlp_tpu.train.steps import prepare_batch as jax_prepare_batch
from demovlp_tpu_torch import serve
from demovlp_tpu_torch.cli import common
from demovlp_tpu_torch.convert.from_jax import from_jax
from demovlp_tpu_torch.data.mlm import mask_batch_text_tokens
from demovlp_tpu_torch.train.retrieval import RetrievalTrainer
from demovlp_tpu_torch.train.steps import (batch_to_device, make_retrieval_eval_step,
                                           make_retrieval_train_step, mlm_loss_fn)

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ROOT / "configs" / "smoke" / "synthetic_retrieval.json"
BUCKETS = [16, 32]  # every smoke batch trims to 16: one compiled JAX step
MODEL_KEYS = ("input_ids", "attention_mask", "object", "object_mask")
F32_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6, scale_atol=1e-4)
SEED = 4


def _cfg():
    cfg = json.loads(SMOKE.read_text())
    cfg["mlm"] = {"weight": 0.5, "mask_prob": 0.15, "mask_token_id": 103}
    cfg["trainer"]["text_buckets"] = BUCKETS
    return cfg


@pytest.mark.parametrize("seed,prob", [(0, 0.15), (1, 0.5), (2, 0.9)])
def test_masks_bit_identical_to_jax(seed, prob):
    rng = np.random.default_rng(100 + seed)
    ids = rng.integers(1000, 30522, size=(6, 20)).astype(np.int32)
    mask = (np.arange(20)[None] < rng.integers(3, 21, size=(6, 1))).astype(np.int32)
    ids[:, 0] = 101
    ids[np.arange(6), mask.sum(1) - 1] = 102
    ids[mask == 0] = 0
    got = mask_batch_text_tokens(ids, mask, 103, 30522, np.random.default_rng(seed), prob)
    want = jax_mask(ids, mask, 103, 30522, np.random.default_rng(seed), prob)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    labels = got[1]
    assert np.all(labels[(mask == 0) | (ids == 101) | (ids == 102)] == -100)
    assert np.any(labels != -100)


def test_mlm_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, size=(3, 7))
    labels[rng.random((3, 7)) < 0.6] = -100
    got = float(mlm_loss_fn(torch.from_numpy(logits), torch.from_numpy(labels)))
    want = float(jax_mlm_loss(jnp.asarray(logits), jnp.asarray(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    none = np.full((3, 7), -100)
    assert float(mlm_loss_fn(torch.from_numpy(logits), torch.from_numpy(none))) == 0.0


@pytest.fixture(scope="module")
def mlm(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mlm")
    cfg = _cfg()
    config = JaxConfig(config=cfg, test=True)
    jmodel, jloss = jcommon.build_model(config), jcommon.build_loss(config)
    tx = jcommon.build_optimizer(config)
    assert jmodel.with_mlm
    model = common.build_model(cfg)
    opt = common.build_optimizer(cfg, model.parameters())
    dl = common.init_dataloaders(cfg, val_split="val")[0][0]
    trainer = RetrievalTrainer(model, common.build_loss(cfg), [], opt, cfg, tmp, "cpu",
                               data_loader=[dl], tokenizer=JaxTokenizer(), rng_seed=SEED)
    dl.set_epoch(1)
    it = iter(dl)
    data = [next(it), next(it)]
    # the JAX trainer's batch path: bucket, then mask from default_rng(seed + 1)
    jrng = np.random.default_rng(SEED + 1)
    jb = []
    for d in data:
        a = {k: v for k, v in jax_prepare_batch(d, JaxTokenizer(), text_buckets=BUCKETS).items()
             if k in MODEL_KEYS}
        a["input_ids"], a["mlm_labels"] = jax_mask(a["input_ids"], a["attention_mask"], 103,
                                                   30522, jrng, 0.15)
        jb.append(a)
    tb = [trainer.train_arrays(d) for d in data]
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), {k: jb[0][k] for k in MODEL_KEYS}))
    model.load_state_dict(from_jax(params), strict=True)

    def loss_fn(p, batch):
        out = jmodel.apply(p, batch, deterministic=True)
        total, g, l = _retrieval_losses(jloss, out, batch)
        mlm_loss = jax_mlm_loss(out["mlm_logits"], batch["mlm_labels"])
        return total + 0.5 * mlm_loss, (g, l, mlm_loss, out["mlm_logits"])

    # the JAX train step's body (make_retrieval_train_step, mlm_weight 0.5,
    # deterministic), one compile for both steps: every batch trims to 16
    value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    update = jax.jit(tx.update)
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
    # the trainer's step with dropout off
    tstep = make_retrieval_train_step(model, trainer.loss, opt, deterministic=True,
                                      mlm_weight=trainer.mlm_weight)
    jm, tm, jgrads1, jlogits, tgrads1, tlogits = [], [], None, None, None, None
    for a, b in zip(jb, tb):
        (total, (g, l, mlm_loss, logits)), grads = value_and_grad(state.params, a)
        jm.append({"loss": float(total), "global_loss": float(g), "local_loss": float(l),
                   "mlm_loss": float(mlm_loss)})
        opt_state = state.opt_state
        opt_state.hyperparams["learning_rate"] = jnp.asarray(1e-4, jnp.float32)
        updates, new_opt = update(grads, opt_state, state.params)
        state = TrainState(params=optax.apply_updates(state.params, updates),
                           opt_state=new_opt, step=state.step + 1)
        batch = batch_to_device(b, torch.device("cpu"))
        if jgrads1 is None:
            jgrads1, jlogits = grads, np.asarray(logits)
            model.eval()
            with torch.no_grad():
                tlogits = model(batch, mlm=True)["mlm_logits"]
        tm.append({k: float(v) for k, v in tstep(batch, 1e-4).items()})
        if tgrads1 is None:
            tgrads1 = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return dict(jb=jb, tb=tb, jm=jm, tm=tm, params=params, model=model,
                jgrads1=from_jax(jax.tree_util.tree_map(np.asarray, jgrads1)),
                tgrads1=tgrads1, jlogits=jlogits, tlogits=tlogits.numpy(), cfg=cfg)


def test_trainer_masks_match_jax_trainer(mlm):
    for a, b in zip(mlm["jb"], mlm["tb"]):
        assert b["input_ids"].shape[1] in BUCKETS
        for k in ("input_ids", "attention_mask", "mlm_labels"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        assert np.any(b["mlm_labels"] != -100)


def test_head_logits_match_jax(mlm):
    assert mlm["tlogits"].shape == mlm["jlogits"].shape
    assert mlm["tlogits"].shape[-1] == 30522
    np.testing.assert_allclose(mlm["tlogits"], mlm["jlogits"], **F32_TOL)


def test_from_jax_carries_the_head(mlm):
    sd = from_jax(mlm["params"])
    head = {k for k in sd if k.startswith("mlm_head.")}
    assert head == {f"mlm_head.{m}.{p}" for m in ("vocab_transform", "vocab_layer_norm",
                                                  "vocab_projector") for p in ("weight", "bias")}
    plain = common.build_model(json.loads(SMOKE.read_text()))
    plain.load_state_dict({k: v for k, v in sd.items() if k not in head}, strict=True)
    with pytest.raises(RuntimeError):
        plain.load_state_dict(sd, strict=True)  # the head needs a model with_mlm


def test_two_mlm_steps_match_jax(mlm):
    for i, (jm, tm) in enumerate(zip(mlm["jm"], mlm["tm"])):
        for k in ("loss", "global_loss", "local_loss", "mlm_loss"):
            np.testing.assert_allclose(tm[k], jm[k], err_msg=f"step {i + 1} {k}", **LOSS_TOL)
        assert tm["mlm_loss"] > 0
    assert mlm["tm"][0]["loss"] != mlm["tm"][1]["loss"]


def test_mlm_step1_gradients_match_jax(mlm):
    want, got = mlm["jgrads1"], mlm["tgrads1"]
    assert set(got) == set(want) and "mlm_head.vocab_projector.weight" in got
    for name, g in got.items():
        scale = float(want[name].abs().max())
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=GRAD_TOL["rtol"],
                                   atol=GRAD_TOL["atol"] + GRAD_TOL["scale_atol"] * scale,
                                   err_msg=name)


def test_eval_and_serving_skip_the_head(mlm):
    model = mlm["model"]
    calls = []
    handle = model.mlm_head.register_forward_hook(lambda *a: calls.append(1))
    try:
        batch = batch_to_device(mlm["tb"][0], torch.device("cpu"))
        out, _ = make_retrieval_eval_step(model, common.build_loss(mlm["cfg"]))(
            {k: batch[k] for k in MODEL_KEYS})
        assert "mlm_logits" not in out
        serve.make_embed_step(model)({k: batch[k] for k in MODEL_KEYS})
        serve.make_text_embed_step(model)(batch["input_ids"], batch["attention_mask"])
    finally:
        handle.remove()
    assert calls == []
