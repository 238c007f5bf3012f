"""Multiple choice, on the CPU, against the JAX package:
configs/smoke/synthetic_mc.json (f32), the JAX ObjectMCRelation's params
carried across with `from_jax`.

* Scores: for each of the first four items, the option scores of the port's
  batch-1 step (`make_mc_eval_step`), of its batched step
  (`make_mc_eval_step_batched`, the four items in one call) and of the JAX
  package's `make_mc_eval_step`. The batched and batch-1 forms compute each
  item's numbers in the same order: rtol 1e-6 / atol 1e-6. Against JAX,
  rtol 1e-4 / atol 1e-5: the towers' f32 summation order (as
  tests/test_torch_models.py holds them), and the local part goes through
  the kernel's plain version where JAX runs its model-side XLA form, which
  differ only on fully masked rows, absent here.
* Data and metrics: the port's synthetic mc items equal the JAX dataset's;
  `evaluate_mc` equals the JAX one; `merge_mc_predictions` refuses an
  unknown id.
* CLI: the eval-only run of the smoke config with `--device cpu`, batched
  and batch-1, with the same predictions.
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
from demovlp_tpu.data.datasets import dataset_object_loader as jax_dataset
from demovlp_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer
from demovlp_tpu.metrics import qa as jqa
from demovlp_tpu.parallel import create_mesh
from demovlp_tpu.train.steps import make_mc_eval_step as jax_mc_step
from demovlp_tpu.train.steps import prepare_batch as jax_prepare_batch
from demovlp_tpu_torch.cli import common
from demovlp_tpu_torch.cli.train_mc import run
from demovlp_tpu_torch.convert.from_jax import from_jax
from demovlp_tpu_torch.data.loader import collate
from demovlp_tpu_torch.data.tokenizer import SimpleTokenizer
from demovlp_tpu_torch.metrics import qa as tqa
from demovlp_tpu_torch.train.mc import merge_mc_predictions
from demovlp_tpu_torch.train.steps import (batch_to_device, make_mc_eval_step,
                                           make_mc_eval_step_batched, prepare_batch)

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ROOT / "configs" / "smoke" / "synthetic_mc.json"
KEYS = ("input_ids", "attention_mask", "object", "object_mask")
N_ITEMS = 4


def _smoke():
    return json.loads(SMOKE.read_text())


def _item_arrays(ds, i, tokenizer, prepare):
    data = collate([ds.get_item(i, np.random.default_rng(0))])
    arrays = {k: v for k, v in prepare(data, tokenizer).items() if k in KEYS}
    n_opt = arrays["input_ids"].shape[0]
    arrays["object"] = np.repeat(data["object"], n_opt, axis=0)
    arrays["object_mask"] = np.repeat(data["object_mask"], n_opt, axis=0)
    return arrays


@pytest.fixture(scope="module")
def scores():
    cfg = _smoke()
    config = JaxConfig(config=cfg, test=True)
    jmodel = jcommon.build_model(config)
    jloss = jcommon.build_loss(config)
    ds = common.init_dataloaders(cfg, val_split="test")[1][0].dataset
    items = [_item_arrays(ds, i, SimpleTokenizer(), prepare_batch) for i in range(N_ITEMS)]
    jitems = [_item_arrays(ds, i, JaxTokenizer(), jax_prepare_batch) for i in range(N_ITEMS)]
    for a, b in zip(items, jitems):
        for k in KEYS:
            np.testing.assert_array_equal(a[k], b[k])
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jitems[0]))
    jstep = jax_mc_step(jmodel, jloss, create_mesh(devices=jax.devices()[:1]))
    want = np.stack([np.asarray(jstep(jax.tree_util.tree_map(jnp.asarray, params), b))
                     for b in jitems])

    model = common.build_model(cfg)
    model.load_state_dict(from_jax(params), strict=True)
    loss = common.build_loss(cfg)
    cpu = torch.device("cpu")
    one = make_mc_eval_step(model, loss)
    single = np.stack([one(batch_to_device(b, cpu)).numpy() for b in items])
    stacked = {k: np.stack([b[k] for b in items]) for k in KEYS}
    batched = make_mc_eval_step_batched(model, loss)(batch_to_device(stacked, cpu)).numpy()
    return dict(want=want, single=single, batched=batched)


def test_scores_have_one_entry_per_option(scores):
    for k in ("want", "single", "batched"):
        assert scores[k].shape == (N_ITEMS, 5), k
        assert np.isfinite(scores[k]).all()


def test_batched_scores_equal_batch_1(scores):
    np.testing.assert_allclose(scores["batched"], scores["single"], rtol=1e-6, atol=1e-6)


def test_scores_match_jax(scores):
    np.testing.assert_allclose(scores["single"], scores["want"], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(scores["single"].argmax(1), scores["want"].argmax(1))


def test_mc_items_match_jax():
    cfg = _smoke()
    args = cfg["data_loader"]["args"]
    ds = common.init_dataloaders(cfg, val_split="test")[1][0].dataset
    jds = jax_dataset(args["dataset_name"], text_params=args["text_params"],
                      object_params=args["object_params"], split="test")
    assert ds.id2answer == jds.id2answer
    for i in range(len(ds)):
        a, b = ds.get_item(i, np.random.default_rng(i)), jds.get_item(i, np.random.default_rng(i))
        assert a["text"] == b["text"] and len(a["text"]) == 5
        assert (a["label"], a["mc_id"]) == (b["label"], b["mc_id"])
        np.testing.assert_array_equal(a["object"], b["object"])


def test_evaluate_mc_matches_jax():
    rng = np.random.RandomState(3)
    gt = {i: int(rng.randint(5)) for i in range(30)}
    pred = {i: int(rng.randint(5)) for i in range(0, 30, 2)}
    assert tqa.evaluate_mc(pred, gt) == jqa.evaluate_mc(pred, gt)


def test_merge_mc_predictions_checks_ids():
    assert merge_mc_predictions({3: 1, 0: 4}, [0, 1, 2, 3]) == {3: 1, 0: 4}
    with pytest.raises(KeyError):
        merge_mc_predictions({7: 1}, [0, 1, 2, 3])


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mc_cli")
    out = {}
    for batch in (8, 1):
        cfg = _smoke()
        cfg["trainer"].update(save_dir=str(tmp), mc_eval_batch=batch)
        path = tmp / f"cfg{batch}.json"
        path.write_text(json.dumps(cfg))
        out[batch] = run(["-c", str(path), "--device", "cpu"])
    return out


def test_cli_evaluates_on_cpu(cli_runs):
    log = cli_runs[8].final_log
    assert log["epoch"] == 0
    assert 0.0 <= float(log["val_0_evaluate_mc_mc_accuracy"]) <= 100.0


def test_cli_batched_and_batch_1_predict_alike(cli_runs):
    dl = cli_runs[8].valid_data_loader[0]
    assert cli_runs[8].predict(dl) == cli_runs[1].predict(dl)
    assert len(cli_runs[8].predict(dl)) == len(dl.dataset)
