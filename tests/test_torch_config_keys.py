"""The train settings of the JAX package's `-fast` pre-training path, on the
CPU: the three train CLIs accept `trainer.text_buckets`, `mlm.weight` > 0,
`data_loader.args.length_grouped` and the top-level `remat`, and train the
smoke configs with them (`--device cpu`); absent, empty or 0 they train as
before. configs/pt/o2t-cl-local-select-loss-cc-fast.json, narrowed as
tests/test_torch_loader_real.py narrows its config (2 + 2 layers, width
64, f32) with the synthetic long-tail dataset in place of WebVid and CC3M,
builds and trains its steps through both length-grouped loaders, and
without `--device cpu` on a machine with no card it raises."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from demovlp_tpu_torch.cli import common
from demovlp_tpu_torch.cli import train as train_cli
from demovlp_tpu_torch.cli import train_mc as mc_cli
from demovlp_tpu_torch.cli import train_qa as qa_cli

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ROOT / "configs" / "smoke"
FAST = ROOT / "configs" / "pt" / "o2t-cl-local-select-loss-cc-fast.json"
_PATHS = {"retrieval": train_cli, "qa": qa_cli, "mc": mc_cli}


def _run(tmp_path, task: str, change, cfg=None):
    cfg = cfg or json.loads((SMOKE / f"synthetic_{task}.json").read_text())
    cfg["trainer"].update(save_dir=str(tmp_path), epochs=1, init_val=False)
    change(cfg)
    out = tmp_path / "cfg.json"
    out.write_text(json.dumps(cfg))
    return _PATHS[task].run(["-c", str(out), "--device", "cpu"])


def _buckets(cfg):
    cfg["trainer"]["text_buckets"] = [8, 12, 16]


def _mlm(cfg):
    cfg["mlm"] = {"weight": 0.5, "mask_prob": 0.15, "mask_token_id": 103}


def _grouped(cfg):
    cfg["data_loader"]["args"]["length_grouped"] = True


def _remat(cfg):
    cfg["remat"] = True


def _all(cfg):
    for change in (_buckets, _mlm, _grouped, _remat):
        change(cfg)


@pytest.mark.parametrize("task,change", [
    ("retrieval", _buckets), ("retrieval", _mlm), ("retrieval", _grouped), ("retrieval", _remat),
    ("retrieval", _all), ("qa", _buckets), ("qa", _grouped), ("qa", _remat),
], ids=["retrieval-buckets", "retrieval-mlm", "retrieval-grouped", "retrieval-remat",
        "retrieval-all", "qa-buckets", "qa-grouped", "qa-remat"])
def test_train_cli_accepts_and_trains(tmp_path, task, change):
    trainer = _run(tmp_path, task, change)
    assert len(trainer.step_losses) == 4 and all(np.isfinite(trainer.step_losses))
    assert (tmp_path / "models").exists()
    cfg = json.loads((next((tmp_path / "models").rglob("config.json"))).read_text())
    buckets = cfg["trainer"].get("text_buckets")
    assert all(n in (buckets or [100]) for n in trainer.step_text_lens)
    assert trainer.model.object_model.remat == bool(cfg.get("remat"))
    grouped = bool(cfg["data_loader"]["args"].get("length_grouped"))
    assert trainer.data_loader[0].length_grouped == grouped
    # the loader groups by the edges the trainer trims to
    assert trainer.data_loader[0].text_buckets == tuple(buckets or (32, 48, 64))
    if task == "retrieval":
        assert (trainer.model.mlm_head is not None) == (trainer.mlm_weight > 0)


def test_mc_cli_accepts_the_keys(tmp_path):
    trainer = _run(tmp_path, "mc", lambda cfg: (_buckets(cfg), _remat(cfg)))
    assert trainer.model.object_model.remat
    assert 0.0 <= float(trainer.final_log["val_0_evaluate_mc_mc_accuracy"]) <= 100.0


@pytest.mark.parametrize("change", [
    lambda cfg: cfg["trainer"].update(text_buckets=[]) or cfg.update(mlm={"weight": 0}),
    lambda cfg: cfg["trainer"].update(text_buckets=None) or cfg.update(
        mlm={"weight": 0.0, "mask_prob": 0.15}, remat=False),
], ids=["empty-zero", "none-zero-false"])
def test_empty_or_zero_trains_as_before(tmp_path, change):
    trainer = _run(tmp_path, "retrieval", change)
    assert trainer.step_text_lens == [100] * 4
    assert trainer.model.mlm_head is None and not trainer.model.object_model.remat
    assert trainer.mlm_weight == 0


def test_mlm_on_the_qa_arch_is_refused(tmp_path):
    with pytest.raises(ValueError, match="mlm.weight"):
        _run(tmp_path, "qa", _mlm)


def _narrow_fast():
    cfg = json.loads(FAST.read_text())
    assert cfg["trainer"]["text_buckets"] == [32, 48, 64]
    args = cfg["arch"]["args"]
    args["object_params"].update(embed_dim=64, depth=2, heads=4)
    args["text_params"].update(model="", pretrained=False, config=dict(
        vocab_size=30522, dim=64, n_layers=2, n_heads=4, hidden_dim=128,
        max_position_embeddings=128))
    args["projection_dim"] = 64
    cfg["precision"]["compute"] = "float32"
    for i, sec in enumerate(cfg["data_loader"]):
        assert sec["args"]["length_grouped"] is True
        sec["args"].update(dataset_name="SyntheticObjectSelect", batch_size=8, num_workers=2)
        sec["args"]["object_params"].update(num_samples=48 + 16 * i, task="retrieval",
                                            caption_style="long_tail")
    cfg["trainer"]["max_samples_per_epoch"] = 64
    return cfg


def test_fast_pretrain_config_trains_narrowed(tmp_path):
    cfg = _narrow_fast()
    trainer = _run(tmp_path, "retrieval", lambda c: None, cfg)
    assert [dl.length_grouped for dl in trainer.data_loader] == [True, True]
    # two loaders zipped: 4 steps each (64 samples over 8 + 8 a step)
    assert len(trainer.step_losses) == 8 and all(np.isfinite(trainer.step_losses))
    assert set(trainer.step_text_lens) <= {32, 48, 64}
    assert trainer.loss.local_loss.local_dtype == "bfloat16"
    assert common.local_score_args(cfg)["focal_type"] == "equal"


def test_fast_pretrain_config_raises_without_a_card(tmp_path, monkeypatch):
    cfg = _narrow_fast()
    cfg["trainer"]["save_dir"] = str(tmp_path)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.run(["-c", str(path)])
    assert not (tmp_path / "models").exists()


def _mesh_model_2(cfg):
    cfg["mesh"] = {"model": 2}


def _pack_small_tp(cfg):
    _mesh_model_2(cfg)
    cfg["optimizer"]["args"]["pack_small"] = True


@pytest.mark.parametrize("task", ["retrieval", "qa", "mc"])
def test_mesh_model_must_divide_the_world_size(tmp_path, task):
    """One process: `mesh.model` 2 is refused naming the key, as JAX
    create_mesh asserts it divides the device count."""
    with pytest.raises(ValueError, match=r"mesh\.model=2 does not divide the world size 1"):
        _run(tmp_path, task, _mesh_model_2)


@pytest.mark.parametrize("cli,extra", [
    ("extract_embeddings", ["--split", "test", "--output", "emb.npz"]),
    ("predict_qa", ["--output", "p.json"]),
    ("query_index", ["--index", "emb.npz", "--query", "a dog"]),
])
def test_serving_clis_read_mesh_model(tmp_path, cli, extra):
    import importlib
    cfg = json.loads((SMOKE / "synthetic_retrieval.json").read_text())
    _mesh_model_2(cfg)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    mod = importlib.import_module(f"demovlp_tpu_torch.cli.{cli}")
    with pytest.raises(ValueError, match=r"mesh\.model=2"):
        mod.run(["-c", str(path), "--device", "cpu", *extra])


def test_pack_small_with_tensor_parallelism_is_refused(tmp_path):
    with pytest.raises(ValueError, match="pack_small"):
        _run(tmp_path, "retrieval", _pack_small_tp)
    cfg = {"optimizer": {"type": "AdamW", "args": {"lr": 1e-4, "pack_small": True}},
           "mesh": {"model": 2}}
    with pytest.raises(ValueError, match="pack_small"):
        common.build_optimizer(cfg, torch.nn.Linear(2, 2).parameters())


def test_mesh_model_1_and_pack_small_train(tmp_path):
    trainer = _run(tmp_path, "retrieval", lambda cfg: (
        cfg.update(mesh={"model": 1}), cfg["optimizer"]["args"].update(pack_small=True)))
    assert trainer.mesh is None and len(trainer.step_losses) == 4
