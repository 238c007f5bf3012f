"""The training slice as a whole, on the CPU, against the JAX package.

* Step parity: configs/smoke/synthetic_retrieval.json (f32), the JAX params
  carried across with `from_jax`, two `deterministic=True` train steps on the
  same batches: the port's `make_retrieval_train_step` against the JAX one
  on a 1-device CPU mesh with its default "xla" local-score backend. In f32
  that path equals the kernel's except on fully masked rows, which the
  synthetic data does not produce.
  Tolerances: losses rtol 1e-5 / atol 1e-6 (f32, summation order only).
  Step-1 gradients rtol 1e-3 / atol 1e-6 + 1e-4 of the tensor's largest
  entry: the local loss's lambda = 20 amplifies summation order, and the
  differences read 2e-5 of that scale at most; a key bias's gradient is
  exactly zero in theory (a softmax ignores a shift per query), and both
  sides give rounding noise of order 1e-7 there. Parameters after step 2:
  Adam's first updates are close to
  lr * sign(g), so an element whose gradient is within rounding of zero
  can move by up to 2 lr in one implementation and not in the other. So
  every parameter is held at atol 2 lr + 1e-6 plus rtol 1e-5, and at most
  0.5% of the elements of the model may lie beyond atol 1e-6 / rtol 1e-5.
* Loader: the port's train loader yields JAX's `RegionDataLoader`
  (process 0 of 1) batches for epochs 1 and 2, sample for sample.
* Metrics: `t2v_metrics` / `v2t_metrics` with ties, both tie-breaks.
* CLI: one epoch with init_val on the smoke config (`--device cpu`) prints
  `val_0_*` metrics and writes checkpoint-epoch1; `resume: "auto"` starts at
  epoch 2; the port's checkpoint loads through the JAX package's
  `load_reference_checkpoint` into the same parameters.
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
from demovlp_tpu.convert import load_reference_checkpoint
from demovlp_tpu.data.datasets import dataset_object_loader as jax_dataset
from demovlp_tpu.data.loader import RegionDataLoader as JaxLoader
from demovlp_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer
from demovlp_tpu.metrics import retrieval as jmetrics
from demovlp_tpu.parallel import create_mesh
from demovlp_tpu.parallel.mesh import shard_batch
from demovlp_tpu.train.state import TrainState
from demovlp_tpu.train.steps import _retrieval_losses
from demovlp_tpu.train.steps import make_retrieval_train_step as jax_train_step
from demovlp_tpu.train.steps import prepare_batch as jax_prepare_batch
from demovlp_tpu_torch.cli import common
from demovlp_tpu_torch.cli.train import run
from demovlp_tpu_torch.convert.from_jax import from_jax
from demovlp_tpu_torch.data.tokenizer import SimpleTokenizer
from demovlp_tpu_torch.metrics import retrieval as tmetrics
from demovlp_tpu_torch.train.optim import step_decay_lr
from demovlp_tpu_torch.train.steps import batch_to_device, make_retrieval_train_step, prepare_batch

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ROOT / "configs" / "smoke" / "synthetic_retrieval.json"
MODEL_KEYS = ("input_ids", "attention_mask", "object", "object_mask")
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6, scale_atol=1e-4)
TIGHT = dict(rtol=1e-5, atol=1e-6)
MAX_LOOSE_SHARE = 0.005


def _smoke():
    return json.loads(SMOKE.read_text())


@pytest.fixture(scope="module")
def steps():
    cfg = _smoke()
    config = JaxConfig(config=cfg, test=True)
    jmodel = jcommon.build_model(config)
    jloss = jcommon.build_loss(config)
    tx = jcommon.build_optimizer(config)
    ttrain, _ = common.init_dataloaders(cfg, val_split="val")
    dl = ttrain[0]
    dl.set_epoch(1)
    it = iter(dl)
    data = [next(it), next(it)]
    tb = [{k: v for k, v in prepare_batch(d, SimpleTokenizer()).items()} for d in data]
    jb = [{k: v for k, v in jax_prepare_batch(d, JaxTokenizer()).items() if k in MODEL_KEYS}
          for d in data]
    for a, b in zip(tb, jb):
        for k in MODEL_KEYS:
            np.testing.assert_array_equal(a[k], b[k])

    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jb[0]))
    lr = step_decay_lr(1, 1e-4, 2e-4, [30, 40])

    def loss_fn(p, batch):
        out = jmodel.apply(p, batch, deterministic=True)
        return _retrieval_losses(jloss, out, batch)[0]

    jgrads1 = jax.grad(loss_fn)(jax.tree_util.tree_map(jnp.asarray, params), jb[0])
    mesh = create_mesh(devices=jax.devices()[:1])
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
    jstep = jax_train_step(jmodel, jloss, tx, mesh, deterministic=True)
    jm = []
    for b in jb:
        state, m = jstep(state, shard_batch(b, mesh), lr, jax.random.PRNGKey(0))
        jm.append({k: float(v) for k, v in m.items()})

    model = common.build_model(cfg)
    model.load_state_dict(from_jax(params), strict=True)
    opt = common.build_optimizer(cfg, model.parameters())
    tstep = make_retrieval_train_step(model, common.build_loss(cfg), opt, deterministic=True)
    tm, tgrads1 = [], None
    for b in tb:
        m = tstep(batch_to_device(b, torch.device("cpu")), lr)
        tm.append({k: float(v) for k, v in m.items()})
        if tgrads1 is None:
            tgrads1 = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return dict(jm=jm, tm=tm, jgrads1=from_jax(jax.tree_util.tree_map(np.asarray, jgrads1)),
                tgrads1=tgrads1, jparams=from_jax(jax.tree_util.tree_map(np.asarray,
                                                                          state.params)),
                tparams=dict(model.named_parameters()), lr=lr)


def test_step_losses_match(steps):
    for jm, tm in zip(steps["jm"], steps["tm"]):
        for k in ("loss", "global_loss", "local_loss"):
            np.testing.assert_allclose(tm[k], jm[k], err_msg=k, **LOSS_TOL)
    assert steps["tm"][0]["loss"] != steps["tm"][1]["loss"]


def test_step1_gradients_match(steps):
    want, got = steps["jgrads1"], steps["tgrads1"]
    assert set(got) == set(want)
    for name, g in got.items():
        scale = float(want[name].abs().max())
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=GRAD_TOL["rtol"],
                                   atol=GRAD_TOL["atol"] + GRAD_TOL["scale_atol"] * scale,
                                   err_msg=name)


def test_parameters_after_two_steps_match(steps):
    want, got, lr = steps["jparams"], steps["tparams"], steps["lr"]
    assert set(got) == set(want)
    loose, total = 0, 0
    for name, p in got.items():
        a, b = p.detach().numpy(), want[name].numpy()
        np.testing.assert_allclose(a, b, rtol=TIGHT["rtol"], atol=2 * lr + TIGHT["atol"],
                                   err_msg=name)
        loose += int(np.sum(np.abs(a - b) > TIGHT["atol"] + TIGHT["rtol"] * np.abs(b)))
        total += a.size
    assert loose / total <= MAX_LOOSE_SHARE, (loose, total)


def test_train_loader_matches_jax():
    cfg = _smoke()
    args = cfg["data_loader"]["args"]
    ttrain, _ = common.init_dataloaders(cfg)
    tdl = ttrain[0]
    ds = jax_dataset(args["dataset_name"], text_params=args["text_params"],
                     object_params=args["object_params"], split="train")
    jdl = JaxLoader(ds, batch_size=args["batch_size"], shuffle=True, drop_last=True, seed=0,
                    num_workers=2, process_index=0, process_count=1)
    assert len(tdl) == len(jdl) == args["object_params"]["num_samples"] // args["batch_size"]
    orders = []
    for epoch in (1, 2):
        tdl.set_epoch(epoch)
        jdl.set_epoch(epoch)
        order = []
        for tb, jb in zip(tdl, jdl, strict=True):
            assert [m["paths"] for m in tb["meta"]] == [m["paths"] for m in jb["meta"]]
            assert tb["text"] == jb["text"]
            np.testing.assert_array_equal(tb["object"], jb["object"])
            np.testing.assert_array_equal(tb["object_mask"], jb["object_mask"])
            order += [m["paths"] for m in tb["meta"]]
        orders.append(order)
    assert orders[0] != orders[1]  # a new permutation each epoch


@pytest.mark.parametrize("ties", ["optimistically", "averaging"])
@pytest.mark.parametrize("per_video", [1, 2])
def test_retrieval_metrics_match_jax(ties, per_video):
    rng = np.random.RandomState(4)
    n_vid = 12
    sims = np.round(rng.randn(n_vid * per_video, n_vid), 1).astype(np.float32)  # many ties
    sims[3, :] = 0.5  # a query tied with every video
    for fn in ("t2v_metrics", "v2t_metrics"):
        want = getattr(jmetrics, fn)(sims, break_ties=ties)
        got = getattr(tmetrics, fn)(sims, break_ties=ties)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=f"{fn} {k}")
    assert tmetrics.METRICS["t2v_metrics"] is tmetrics.t2v_metrics


def _cli_config(tmp_path, **trainer):
    cfg = _smoke()
    cfg["trainer"].update(save_dir=str(tmp_path), **trainer)
    path = tmp_path / f"cfg_{len(list(tmp_path.glob('cfg_*.json')))}.json"
    path.write_text(json.dumps(cfg))
    return path


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_cli")
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("DEMOVLP_RUN_ID", "run1")
        first = run(["-c", str(_cli_config(tmp)), "--device", "cpu"])
        mp.setenv("DEMOVLP_RUN_ID", "run2")
        second = run(["-c", str(_cli_config(tmp, epochs=2, init_val=False, resume="auto")),
                      "--device", "cpu"])
    finally:
        mp.undo()
    return dict(tmp=tmp, first=first, second=second,
                run1=tmp / "models" / "SyntheticSmoke" / "run1",
                run2=tmp / "models" / "SyntheticSmoke" / "run2")


def test_cli_trains_one_epoch_and_saves(cli_runs):
    first, run1 = cli_runs["first"], cli_runs["run1"]
    log = first.final_log
    assert log["epoch"] == 1
    assert np.isfinite(log["loss_0"]) and np.isfinite(log["val_loss_0"])
    for k in ("val_0_t2v_metrics_R1", "val_0_t2v_metrics_R5", "val_0_v2t_metrics_R10",
              "val_0_t2v_metrics_MedR"):
        assert k in log
    assert len(first.step_losses) == 4  # 32 samples, batch 8
    assert (run1 / "checkpoint-epoch1.pth").exists()
    assert (run1 / "model_best.pth").exists()  # monitor "min val_loss_0"
    assert json.loads((run1 / "config.json").read_text())["name"] == "SyntheticSmoke"


def test_cli_resume_auto_starts_at_epoch_2(cli_runs):
    second, run2 = cli_runs["second"], cli_runs["run2"]
    assert second.start_epoch == 2
    assert second.final_log["epoch"] == 2
    assert len(second.step_losses) == 4  # one epoch only
    assert (run2 / "checkpoint-epoch2.pth").exists()
    assert not (run2 / "checkpoint-epoch1.pth").exists()
    ckpt = torch.load(run2 / "checkpoint-epoch2.pth", map_location="cpu", weights_only=True)
    assert ckpt["epoch"] == 2 and ckpt["arch"] == "ObjectRelation"
    assert set(ckpt) == {"arch", "epoch", "state_dict", "optimizer", "monitor_best", "config"}


def test_checkpoint_loads_in_the_jax_package(cli_runs):
    path = cli_runs["run1"] / "checkpoint-epoch1.pth"
    params = load_reference_checkpoint(str(path), num_frames=2, depth=2, n_text_layers=2,
                                       strict=True)
    want = torch.load(path, map_location="cpu", weights_only=True)["state_dict"]
    got = from_jax(jax.tree_util.tree_map(np.asarray, params))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
