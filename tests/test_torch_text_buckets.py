"""Text trimmed to length buckets (`trainer.text_buckets`), on the CPU,
against the JAX package.

* Bucket selection: the port's `prepare_batch(..., text_buckets=...)`
  gives the JAX `prepare_batch`'s arrays on batches whose longest text
  lands below, on and above each bucket edge, past the largest bucket and
  past the fixed length, and on multiple-choice options; no token is ever
  trimmed (every row keeps its attention-mask sum).
* One deterministic retrieval train step (configs/smoke/synthetic_retrieval.json,
  f32) and one QA step (configs/smoke/synthetic_qa.json) on a batch trimmed
  to a bucket, from the same weights (the JAX params carried across with
  `from_jax`): losses and gradients at tests/test_torch_train.py's
  LOSS_TOL / GRAD_TOL. On this data trimming moves the local loss (its
  mean over every query position, pads included) and QA's max-pool over
  all positions, as PARITY.md #14 states, so the trimmed and the untrimmed
  losses differ, and both packages agree on the trimmed one.
* The retrieval and QA trainers trim train batches and keep validation at
  the full length.
"""
from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demovlp_tpu.cli import common as jcommon
from demovlp_tpu.config import ConfigParser as JaxConfig
from demovlp_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer
from demovlp_tpu.train.steps import _retrieval_losses
from demovlp_tpu.train.steps import parse_text_buckets as jax_parse_text_buckets
from demovlp_tpu.train.steps import prepare_batch as jax_prepare_batch
from demovlp_tpu_torch.cli import common
from demovlp_tpu_torch.cli import train as train_cli
from demovlp_tpu_torch.cli import train_qa as qa_cli
from demovlp_tpu_torch.convert.from_jax import from_jax
from demovlp_tpu_torch.data.tokenizer import SimpleTokenizer
from demovlp_tpu_torch.train.steps import (batch_to_device, make_qa_train_step,
                                           make_retrieval_train_step, parse_text_buckets,
                                           prepare_batch, retrieval_losses)

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ROOT / "configs" / "smoke"
BUCKETS = [32, 48, 64]
SMOKE_BUCKETS = [8, 12, 16]  # the smoke captions are 3-9 words
MODEL_KEYS = ("input_ids", "attention_mask", "object", "object_mask")
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6, scale_atol=1e-4)


def _words(n: int) -> str:
    return " ".join(["park"] * n)


# longest text in tokens = words + 2 ([CLS], [SEP]); the fixed length is 100
@pytest.mark.parametrize("lengths,want", [
    ([3, 5, 1], 32),
    ([30, 2], 32),  # 32 tokens: on the edge of 32
    ([31, 4], 48),  # 33 tokens
    ([46], 48),
    ([47, 3], 64),
    ([62], 64),
    ([63, 10], 100),  # 65 tokens: past the largest bucket, not trimmed
    ([150, 3], 100),  # truncated to the fixed length
], ids=["short", "edge-32", "past-32", "edge-48", "past-48", "edge-64", "past-64",
        "past-fixed"])
def test_bucket_selection_matches_jax(lengths, want):
    batch = {"text": [_words(n) for n in lengths],
             "object": np.zeros((len(lengths), 1, 2, 2054), np.float32),
             "object_mask": np.ones((len(lengths), 1, 2), np.float32)}
    full = prepare_batch(batch, SimpleTokenizer())
    got = prepare_batch(batch, SimpleTokenizer(), text_buckets=BUCKETS)
    ref = jax_prepare_batch(batch, JaxTokenizer(), text_buckets=BUCKETS)
    assert got["input_ids"].shape == (len(lengths), want)
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(got["attention_mask"].sum(1), full["attention_mask"].sum(1))
    np.testing.assert_array_equal(got["input_ids"], full["input_ids"][:, :want])


def test_multiple_choice_options_are_bucketed_together():
    text = [[_words(3), _words(40)], [_words(2), _words(5)]]
    batch = {"text": text, "object": np.zeros((2, 1, 2, 2054), np.float32),
             "object_mask": np.ones((2, 1, 2), np.float32)}
    got = prepare_batch(batch, SimpleTokenizer(), text_buckets=BUCKETS)
    ref = jax_prepare_batch(batch, JaxTokenizer(), text_buckets=BUCKETS)
    assert got["input_ids"].shape == (4, 48)
    np.testing.assert_array_equal(got["input_ids"], ref["input_ids"])


@pytest.mark.parametrize("trainer_cfg,want", [
    ({"text_buckets": [64, 32, 48]}, [32, 48, 64]),
    ({"text_buckets": []}, None),
    ({"text_buckets": None}, None),
    ({}, None),
], ids=["unsorted", "empty", "none", "absent"])
def test_parse_text_buckets_matches_jax(trainer_cfg, want):
    assert parse_text_buckets(trainer_cfg) == jax_parse_text_buckets(trainer_cfg) == want


def _assert_grads(got, want):
    assert set(got) == set(want)
    for name, g in got.items():
        scale = float(want[name].abs().max())
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=GRAD_TOL["rtol"],
                                   atol=GRAD_TOL["atol"] + GRAD_TOL["scale_atol"] * scale,
                                   err_msg=name)


def _first_batch(cfg, keys):
    dl = common.init_dataloaders(cfg, val_split="test")[0][0]
    dl.set_epoch(1)
    data = next(iter(dl))
    tb = prepare_batch(data, SimpleTokenizer(), text_buckets=SMOKE_BUCKETS)
    jb = {k: v for k, v in jax_prepare_batch(data, JaxTokenizer(),
                                             text_buckets=SMOKE_BUCKETS).items() if k in keys}
    for k in keys:
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    return tb, jb, prepare_batch(data, SimpleTokenizer())


def _step_case(task):
    cfg = json.loads((SMOKE / f"synthetic_{task}.json").read_text())
    config = JaxConfig(config=cfg, test=True)
    jmodel, jloss = jcommon.build_model(config), jcommon.build_loss(config)
    keys = MODEL_KEYS + (("label",) if task == "qa" else ())
    tb, jb, full = _first_batch(cfg, keys)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), {k: jb[k] for k in MODEL_KEYS}))

    if task == "qa":
        def loss_fn(p, batch):
            return jloss(jmodel.apply(p, batch, deterministic=True)["logits"], batch["label"])
    else:
        def loss_fn(p, batch):
            out = jmodel.apply(p, batch, deterministic=True)
            return _retrieval_losses(jloss, out, batch)[0]

    jl, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, params), jb)
    model = common.build_model(cfg)
    model.load_state_dict(from_jax(params), strict=True)
    opt = common.build_optimizer(cfg, model.parameters())
    make = make_qa_train_step if task == "qa" else make_retrieval_train_step
    tstep = make(model, common.build_loss(cfg), opt, deterministic=True)
    with torch.no_grad():
        model.eval()
        fb = batch_to_device(full, torch.device("cpu"))
        out = model(fb)
        loss_obj = common.build_loss(cfg)
        full_loss = (loss_obj(out["logits"], fb["label"]) if task == "qa"
                     else retrieval_losses(loss_obj, out, fb)[0])
    m = tstep(batch_to_device(tb, torch.device("cpu")), 1e-4)
    tgrads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return dict(length=tb["input_ids"].shape[1], jloss=float(jl), tloss=float(m["loss"]),
                jgrads=from_jax(jax.tree_util.tree_map(np.asarray, jgrads)), tgrads=tgrads,
                full_loss=full_loss)


@pytest.fixture(scope="module", params=["retrieval", "qa"])
def step_case(request):
    return _step_case(request.param)


def test_trimmed_step_loss_matches_jax(step_case):
    assert step_case["length"] in SMOKE_BUCKETS  # the batch was trimmed
    np.testing.assert_allclose(step_case["tloss"], step_case["jloss"], **LOSS_TOL)
    assert abs(float(step_case["full_loss"]) - step_case["tloss"]) > 1e-5  # trimming moved it


def test_trimmed_step_gradients_match_jax(step_case):
    _assert_grads(step_case["tgrads"], step_case["jgrads"])


def _run(tmp_path, cli, task):
    cfg = json.loads((SMOKE / f"synthetic_{task}.json").read_text())
    cfg["trainer"].update(save_dir=str(tmp_path), text_buckets=SMOKE_BUCKETS)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return cli.run(["-c", str(path), "--device", "cpu"])


@pytest.mark.parametrize("cli,task", [(train_cli, "retrieval"), (qa_cli, "qa")],
                         ids=["retrieval", "qa"])
def test_trainers_trim_train_batches_only(tmp_path, cli, task):
    trainer = _run(tmp_path, cli, task)
    assert len(trainer.step_text_lens) == 4
    assert all(n in SMOKE_BUCKETS for n in trainer.step_text_lens)
    assert all(np.isfinite(trainer.step_losses))
    # validation embeds at the full length
    if task == "retrieval":
        cat, _ = trainer.embed(trainer.valid_data_loader[0])
        assert cat["l_t"].shape[1] == 99
