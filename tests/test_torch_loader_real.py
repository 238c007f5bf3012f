"""The port's loader over real metadata and npz region trees, and the slice
as a whole (configs/ft/msvd_o2t-select.json, narrowed), against the JAX
package.

* Loader: MSVD (train and test) and WebVid (val) fixtures — the first rows
  of the committed metadata and region trees written from a numpy seed —
  through the port's and the JAX package's MultiDistTextObjectVideoDataLoader
  (process 0 of 1): equal batches, batch for batch, over two epochs of a
  train loader and an eval loader, with the native whole-batch decode and
  with DEMOVLP_NATIVE=0; a truncated frame file inside a batch gives the
  same batch on both (the port redoes that row on the per-sample path).
* Slice: the MSVD fine-tune config with narrow towers (2 + 2 layers,
  width 64, D = 64 local embeddings), f32, a random-init text tower, over
  an MSVD fixture: the port's train CLI on the CPU runs its 2 steps with the
  native batch decode; the first batch of its train loader equals the JAX
  loader's, and one deterministic train step on it from the same weights
  (the JAX parameters carried across with `from_jax`) gives the JAX
  package's losses and gradients, at tests/test_torch_train.py's
  tolerances: losses rtol 1e-5 / atol 1e-6, gradients rtol 1e-3 / atol
  1e-6 + 1e-4 of the tensor's largest entry.
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
from demovlp_tpu.data.loader import MultiDistTextObjectVideoDataLoader as JaxLoader
from demovlp_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer
from demovlp_tpu.train.steps import _retrieval_losses
from demovlp_tpu.train.steps import prepare_batch as jax_prepare_batch
from demovlp_tpu_torch.cli import common
from demovlp_tpu_torch.cli.train import run
from demovlp_tpu_torch.convert.from_jax import from_jax
from demovlp_tpu_torch.data import native
from demovlp_tpu_torch.data.loader import MultiDistTextObjectVideoDataLoader
from demovlp_tpu_torch.data.tokenizer import SimpleTokenizer
from demovlp_tpu_torch.train.steps import batch_to_device, make_retrieval_train_step, prepare_batch

from .test_torch_regions import write_frame

ROOT = Path(__file__).resolve().parents[1]
META = ROOT / "meta_data"
MSVD_CFG = ROOT / "configs" / "ft" / "msvd_o2t-select.json"
OBJ_P = {"num_frames": 4, "object_num": 6}
MODEL_KEYS = ("input_ids", "attention_mask", "object", "object_mask")
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6, scale_atol=1e-4)


def _frames(path: Path, n_frames: int, seed: int):
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    for f in range(n_frames):
        write_frame(path / f"{f}.npz", n=int(rng.randint(2, 10)), seed=seed * 50 + f,
                    compressed=f % 3 == 1)


def _fixture(tmp_path, files, n_rows, object_root, min_frames=2):
    """Metadata heads of `n_rows` rows; a region tree for each row's video
    (one video in seven has 2 to 12 frames, the rest 2 to 6; at least
    `min_frames`)."""
    meta = tmp_path / "meta"
    meta.mkdir(exist_ok=True)
    vids = []
    for f in files:
        lines = (META / f).read_text().splitlines(keepends=True)[:n_rows]
        (meta / f).write_text("".join(lines))
        vids += [line.rstrip("\n").split("\t")[1] for line in lines]
    for i, vid in enumerate(vids):
        n = 2 + (i * 5) % 11 if i % 7 == 0 else 2 + i % 5
        _frames(object_root / vid, max(n, min_frames), seed=i)
    return meta


def _assert_same_batch(tb, jb):
    assert tb.keys() == jb.keys()
    assert [m["paths"] for m in tb["meta"]] == [m["paths"] for m in jb["meta"]]
    assert tb["meta"] == jb["meta"] and tb["text"] == jb["text"]
    for key in ("object", "object_mask"):
        assert tb[key].dtype == jb[key].dtype and tb[key].shape == jb[key].shape
        assert np.array_equal(tb[key], jb[key]), key


def _loaders(name, split, objects, batch_size):
    kw = dict(dataset_name=name, text_params={}, object_params=dict(OBJ_P), split=split,
              object_dir=str(objects), batch_size=batch_size, num_workers=3)
    return MultiDistTextObjectVideoDataLoader(**kw), JaxLoader(**kw)


# WebVid does not repeat a short video's last frame (its reference reads 8
# stored frames a video), so its videos hold at least num_frames frames
CASES = {"msvd": ("MSVDObjectSelect", ["MSVD_train.tsv", "MSVD_test.tsv"], "", 2),
         "webvid": ("WebVidObjectSelect", ["webvid_validation_success_full.tsv"], "val",
                    OBJ_P["num_frames"])}


@pytest.mark.parametrize("reader", ["native", "numpy"])
@pytest.mark.parametrize("case", list(CASES))
def test_batches_match_jax(tmp_path, monkeypatch, case, reader):
    name, files, sub, min_frames = CASES[case]
    monkeypatch.setenv("DEMOVLP_META_DIR", str(_fixture(tmp_path, files, 14,
                                                        tmp_path / "objects" / sub, min_frames)))
    if reader == "numpy":
        monkeypatch.setenv("DEMOVLP_NATIVE", "0")
    splits = ("train", "test") if case == "msvd" else ("val",)
    for split in splits:
        tdl, jdl = _loaders(name, split, tmp_path / "objects", batch_size=4)
        assert len(tdl) == len(jdl) > 1
        native.reset_stats()
        epochs = (1, 2) if split == "train" else (0,)
        for epoch in epochs:
            tdl.set_epoch(epoch)
            jdl.set_epoch(epoch)
            for tb, jb in zip(tdl, jdl, strict=True):
                _assert_same_batch(tb, jb)
        frames = sum(b.size for b in tdl.batch_indices()) * OBJ_P["num_frames"] * len(epochs)
        assert native.STATS["frames_native"] == (frames if reader == "native" else 0)
        assert native.STATS["rows_redone"] == 0
        assert tdl.dataset.resample_count == jdl.dataset.resample_count


def test_corrupt_file_gives_the_same_batch(tmp_path, monkeypatch):
    name, files, _, _ = CASES["msvd"]
    monkeypatch.setenv("DEMOVLP_META_DIR", str(_fixture(tmp_path, files, 10, tmp_path / "o")))
    tdl, jdl = _loaders(name, "test", tmp_path / "o", batch_size=5)
    bad = Path(tdl.dataset._object_path(3)) / "1.npz"
    bad.write_bytes(bad.read_bytes()[:2000])
    native.reset_stats()
    for tb, jb in zip(tdl, jdl, strict=True):
        _assert_same_batch(tb, jb)
    assert native.STATS["rows_redone"] == 1
    assert tdl.dataset.resample_count == jdl.dataset.resample_count == 1


# ---- the slice: the MSVD fine-tune, narrowed, on the CPU

def _slice_config(tmp_path):
    meta = _fixture(tmp_path, ["MSVD_train.tsv", "MSVD_test.tsv"], 8, tmp_path / "objects")
    cfg = json.loads(MSVD_CFG.read_text())
    args = cfg["arch"]["args"]
    args["object_params"].update(embed_dim=64, depth=2, heads=4, num_frames=OBJ_P["num_frames"],
                                 object_num=OBJ_P["object_num"])
    args["text_params"].update(model="", pretrained=False, config=dict(
        vocab_size=30522, dim=64, n_layers=2, n_heads=4, hidden_dim=128,
        max_position_embeddings=128))
    args["projection_dim"] = 64
    cfg["precision"]["compute"] = "float32"
    dl = cfg["data_loader"]["args"]
    dl.update(object_dir=str(tmp_path / "objects"), batch_size=4, num_workers=2,
              object_params=dict(OBJ_P))
    cfg["trainer"].update(epochs=1, max_samples_per_epoch=8, save_dir=str(tmp_path / "exps"))
    return cfg, meta


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("msvd_slice")
    cfg, meta = _slice_config(tmp)
    path = tmp / "cfg.json"
    path.write_text(json.dumps(cfg))
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("DEMOVLP_META_DIR", str(meta))
        mp.setenv("DEMOVLP_RUN_ID", "slice")
        native.reset_stats()
        trainer = run(["-c", str(path), "--device", "cpu"])
        stats = dict(native.STATS)
        ttrain, _ = common.init_dataloaders(cfg)
        dl = ttrain[0]
        dl.set_epoch(1)
        data = next(iter(dl))
        jdl = JaxLoader(**{**cfg["data_loader"]["args"]})
        jdl.set_epoch(1)
        jdata = next(iter(jdl))
    finally:
        mp.undo()
    return dict(cfg=cfg, trainer=trainer, stats=stats, data=data, jdata=jdata)


def test_slice_cli_trains_through_the_native_decode(slice_run):
    trainer, stats = slice_run["trainer"], slice_run["stats"]
    assert len(trainer.step_losses) == 2 and np.isfinite(trainer.step_losses).all()
    log = trainer.final_log
    for k in ("val_0_t2v_metrics_R1", "val_0_t2v_metrics_R5", "val_0_t2v_metrics_R10"):
        assert np.isfinite(log[k])
    # 2 train steps of 4 videos and two validation passes (init_val) over
    # the 8 test videos, 4 frames each, every one decoded natively
    assert stats == {"frames_native": (2 * 4 + 2 * 8) * OBJ_P["num_frames"], "rows_redone": 0}
    assert type(trainer.data_loader[0].dataset).__name__ == "MSVDObjectSelect"


@pytest.fixture(scope="module")
def slice_step(slice_run):
    cfg, data = slice_run["cfg"], slice_run["data"]
    config = JaxConfig(config=cfg, test=True)
    jmodel, jloss = jcommon.build_model(config), jcommon.build_loss(config)
    tb = prepare_batch(data, SimpleTokenizer())
    jb = {k: v for k, v in jax_prepare_batch(data, JaxTokenizer()).items() if k in MODEL_KEYS}
    for k in MODEL_KEYS:
        np.testing.assert_array_equal(tb[k], jb[k])
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jb))

    def loss_fn(p, batch):
        total, glob, local = _retrieval_losses(jloss, jmodel.apply(p, batch, deterministic=True),
                                               batch)
        return total, (glob, local)

    (jtotal, (jglobal, jlocal)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jb)
    model = common.build_model(cfg)
    model.load_state_dict(from_jax(params), strict=True)
    opt = common.build_optimizer(cfg, model.parameters())
    step = make_retrieval_train_step(model, common.build_loss(cfg), opt, deterministic=True)
    metrics = step(batch_to_device(tb, torch.device("cpu")), 1e-5)
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return dict(jloss={"loss": float(jtotal), "global_loss": float(jglobal),
                       "local_loss": float(jlocal)}, metrics={k: float(v) for k, v in metrics.items()},
                jgrads=from_jax(jax.tree_util.tree_map(np.asarray, jgrads)), grads=grads)


def test_slice_first_batch_matches_jax(slice_run):
    _assert_same_batch(slice_run["data"], slice_run["jdata"])
    assert slice_run["data"]["object"].shape == (4, OBJ_P["num_frames"], OBJ_P["object_num"],
                                                 2054)


def test_slice_first_step_loss_matches_jax(slice_step):
    for k, want in slice_step["jloss"].items():
        np.testing.assert_allclose(slice_step["metrics"][k], want, err_msg=k, **LOSS_TOL)
    assert slice_step["jloss"]["local_loss"] > 0


def test_slice_first_step_gradients_match_jax(slice_step):
    want, got = slice_step["jgrads"], slice_step["grads"]
    assert set(got) == set(want)
    for name, g in got.items():
        scale = float(want[name].abs().max())
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=GRAD_TOL["rtol"],
                                   atol=GRAD_TOL["atol"] + GRAD_TOL["scale_atol"] * scale,
                                   err_msg=name)
