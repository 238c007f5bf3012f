"""Video QA, on the CPU, against the JAX package: configs/smoke/synthetic_qa.json
(f32, dropout off), the JAX ObjectQARelation's params carried across with
`from_jax`.

* Forward: the logits of the port's ObjectQARelation against the JAX
  model's, rtol 1e-4 / atol 1e-5 (both f32; the towers' summation order, as
  tests/test_torch_models.py holds them).
* Losses: `cross_entropy_loss` and `max_margin_ranking_loss` (both
  `fix_norm` forms) on the same inputs, rtol 1e-6 / atol 1e-6.
* Two train steps: the port's `make_qa_train_step(deterministic=True)`
  against the JAX step's body (`make_qa_train_step` with
  `deterministic=True` in its apply) on the same two batches: losses and
  correct counts, step-1 gradients and parameters after step 2, at the
  tolerances tests/test_torch_train.py states for the retrieval steps.
* Data and metrics: the port's synthetic qa batches equal the JAX
  loader's; `evaluate_qa` equals the JAX one.
* CLI: one epoch of the smoke config with `--device cpu`.
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
from demovlp_tpu.data.datasets import dataset_object_loader as jax_dataset
from demovlp_tpu.data.loader import RegionDataLoader as JaxLoader
from demovlp_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer
from demovlp_tpu.losses import losses as jlosses
from demovlp_tpu.metrics import qa as jqa
from demovlp_tpu.train.state import TrainState
from demovlp_tpu.train.steps import prepare_batch as jax_prepare_batch
from demovlp_tpu_torch.cli import common
from demovlp_tpu_torch.cli.train_qa import run
from demovlp_tpu_torch.convert.from_jax import from_jax
from demovlp_tpu_torch.data.tokenizer import SimpleTokenizer
from demovlp_tpu_torch.losses import losses as tlosses
from demovlp_tpu_torch.metrics import qa as tqa
from demovlp_tpu_torch.train.optim import step_decay_lr
from demovlp_tpu_torch.train.steps import batch_to_device, make_qa_train_step, prepare_batch

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ROOT / "configs" / "smoke" / "synthetic_qa.json"
KEYS = ("input_ids", "attention_mask", "object", "object_mask", "label")
F32_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6, scale_atol=1e-4)
TIGHT = dict(rtol=1e-5, atol=1e-6)
MAX_LOOSE_SHARE = 0.005


def _smoke():
    return json.loads(SMOKE.read_text())


@pytest.fixture(scope="module")
def qa():
    cfg = _smoke()
    config = JaxConfig(config=cfg, test=True)
    jmodel = jcommon.build_model(config)
    jloss = jcommon.build_loss(config)
    tx = jcommon.build_optimizer(config)
    dl = common.init_dataloaders(cfg, val_split="test")[0][0]
    dl.set_epoch(1)
    it = iter(dl)
    data = [next(it), next(it)]
    tb = [prepare_batch(d, SimpleTokenizer()) for d in data]
    jb = [{k: v for k, v in jax_prepare_batch(d, JaxTokenizer()).items() if k in KEYS}
          for d in data]
    for a, b in zip(tb, jb):
        assert set(a) == set(KEYS)
        for k in KEYS:
            np.testing.assert_array_equal(a[k], b[k])
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0),
                                {k: v for k, v in jb[0].items() if k != "label"}))
    lr = step_decay_lr(1, 1e-4, 2e-4, [30, 40])

    def loss_fn(p, batch):
        logits = jmodel.apply(p, batch, deterministic=True)["logits"]
        return jloss(logits, batch["label"]), logits

    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
    jm, jgrads1, jlogits0 = [], None, None
    for b in jb:
        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params, b)
        correct = float(jnp.sum((jnp.argmax(logits, -1) == b["label"]).astype(jnp.float32)))
        if jgrads1 is None:
            jgrads1, jlogits0 = grads, np.asarray(logits)
        opt_state = state.opt_state
        opt_state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        updates, new_opt = tx.update(grads, opt_state, state.params)
        state = TrainState(params=optax.apply_updates(state.params, updates),
                           opt_state=new_opt, step=state.step + 1)
        jm.append({"loss": float(loss), "correct": correct})

    model = common.build_model(cfg)
    model.load_state_dict(from_jax(params), strict=True)
    model.eval()
    with torch.no_grad():
        tlogits0 = model(batch_to_device(tb[0], torch.device("cpu")))["logits"].numpy()
    opt = common.build_optimizer(cfg, model.parameters())
    tstep = make_qa_train_step(model, common.build_loss(cfg), opt, deterministic=True)
    tm, tgrads1 = [], None
    for b in tb:
        m = tstep(batch_to_device(b, torch.device("cpu")), lr)
        tm.append({k: float(v) for k, v in m.items()})
        if tgrads1 is None:
            tgrads1 = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    np2 = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(jm=jm, tm=tm, jlogits0=jlogits0, tlogits0=tlogits0,
                jgrads1=from_jax(np2(jgrads1)), tgrads1=tgrads1,
                jparams=from_jax(np2(state.params)), tparams=dict(model.named_parameters()),
                lr=lr, params=params)


def test_forward_logits_match(qa):
    assert qa["tlogits0"].shape == (8, 10)
    np.testing.assert_allclose(qa["tlogits0"], qa["jlogits0"], **F32_TOL)


def test_from_jax_covers_the_qa_head(qa):
    from demovlp_tpu.convert.torch_export import export_reference_state_dict

    ref = export_reference_state_dict(qa["params"])
    got = from_jax(qa["params"])
    heads = {k for k in ref if k.startswith("head.")}
    assert heads and heads <= set(got)
    for k in heads:
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)


def test_train_step_losses_match(qa):
    for jm, tm in zip(qa["jm"], qa["tm"]):
        np.testing.assert_allclose(tm["loss"], jm["loss"], **LOSS_TOL)
        assert tm["correct"] == jm["correct"]
    assert qa["tm"][0]["loss"] != qa["tm"][1]["loss"]


def test_train_step1_gradients_match(qa):
    want, got = qa["jgrads1"], qa["tgrads1"]
    assert set(got) == set(want)
    for name, g in got.items():
        scale = float(want[name].abs().max())
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=GRAD_TOL["rtol"],
                                   atol=GRAD_TOL["atol"] + GRAD_TOL["scale_atol"] * scale,
                                   err_msg=name)


def test_train_parameters_after_two_steps_match(qa):
    want, got, lr = qa["jparams"], qa["tparams"], qa["lr"]
    assert set(got) == set(want)
    loose, total = 0, 0
    for name, p in got.items():
        a, b = p.detach().numpy(), want[name].numpy()
        np.testing.assert_allclose(a, b, rtol=TIGHT["rtol"], atol=2 * lr + TIGHT["atol"],
                                   err_msg=name)
        loose += int(np.sum(np.abs(a - b) > TIGHT["atol"] + TIGHT["rtol"] * np.abs(b)))
        total += a.size
    assert loose / total <= MAX_LOOSE_SHARE, (loose, total)


def test_cross_entropy_matches_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(7, 13).astype(np.float32) * 3
    labels = rng.randint(0, 13, 7).astype(np.int32)
    want = float(jlosses.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tlosses.CrossEntropy()(torch.from_numpy(logits), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fix_norm", [True, False])
def test_max_margin_ranking_matches_jax(fix_norm):
    x = np.random.RandomState(1).randn(6, 6).astype(np.float32)
    want = float(jlosses.max_margin_ranking_loss(jnp.asarray(x), 0.7, fix_norm))
    got = float(tlosses.MaxMarginRankingLoss(0.7, fix_norm)(torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_qa_loader_matches_jax():
    cfg = _smoke()
    args = cfg["data_loader"]["args"]
    tdl = common.init_dataloaders(cfg)[0][0]
    ds = jax_dataset(args["dataset_name"], text_params=args["text_params"],
                     object_params=args["object_params"], split="train")
    jdl = JaxLoader(ds, batch_size=args["batch_size"], shuffle=True, drop_last=True, seed=0,
                    num_workers=2, process_index=0, process_count=1)
    tdl.set_epoch(1)
    jdl.set_epoch(1)
    for tb, jb in zip(tdl, jdl, strict=True):
        assert tb["text"] == jb["text"]
        np.testing.assert_array_equal(tb["label"], jb["label"])
        np.testing.assert_array_equal(tb["question_id"], jb["question_id"])
        np.testing.assert_array_equal(tb["object"], jb["object"])
    assert tdl.dataset.label2ans == ds.label2ans and tdl.dataset.qid2data == ds.qid2data


def test_evaluate_qa_matches_jax():
    rng = np.random.RandomState(2)
    label2ans = {i: f"ans{i}" for i in range(6)}
    types = list(jqa.ANSWER_TYPES)
    qid2data = {q: {"answer": f"ans{rng.randint(6)}", "answer_type": types[q % 4]}
                for q in range(40)}
    results = [{"question_id": q, "answer": int(rng.randint(6))} for q in range(40)]
    assert tqa.evaluate_qa(results, label2ans, qid2data) == jqa.evaluate_qa(
        results, label2ans, qid2data)


def test_cli_trains_one_epoch_on_cpu(tmp_path, monkeypatch):
    cfg = _smoke()
    cfg["trainer"]["save_dir"] = str(tmp_path)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    monkeypatch.setenv("DEMOVLP_RUN_ID", "qa1")
    trainer = run(["-c", str(path), "--device", "cpu"])
    log = trainer.final_log
    assert log["epoch"] == 1 and np.isfinite(log["loss_0"])
    assert 0.0 <= log["val_0_evaluate_qa_overall_acc"] <= 1.0
    assert 0.0 <= log["train_acc"] <= 1.0
    assert len(trainer.step_losses) == 4  # 32 samples, batch 8
    run_dir = tmp_path / "models" / "SyntheticQASmoke" / "qa1"
    assert (run_dir / "checkpoint-epoch1.pth").exists()
    ckpt = torch.load(run_dir / "checkpoint-epoch1.pth", map_location="cpu", weights_only=True)
    assert ckpt["arch"] == "ObjectQARelation"
    assert any(k.startswith("head.v_att.linear.weight_g") for k in ckpt["state_dict"])
