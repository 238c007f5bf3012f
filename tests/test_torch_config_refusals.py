"""Train settings the JAX trainers read and the port does not: the train
CLIs refuse them before anything is built, instead of training differently
without a word. `trainer.text_buckets` trims text in the JAX retrieval and
QA trainers (demovlp_tpu/train/retrieval.py, train/qa.py); `mlm.weight` > 0
adds the MLM objective (demovlp_tpu/cli/common.py, train/retrieval.py).
Absent, empty or 0, they train as before."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from demovlp_tpu_torch.cli import common
from demovlp_tpu_torch.cli import train as train_cli
from demovlp_tpu_torch.cli import train_qa as qa_cli

SMOKE = Path(__file__).resolve().parents[1] / "configs" / "smoke"
_PATHS = {"retrieval": (train_cli, SMOKE / "synthetic_retrieval.json"),
          "qa": (qa_cli, SMOKE / "synthetic_qa.json")}


def _run(tmp_path, path: str, change):
    cli, cfg_path = _PATHS[path]
    cfg = json.loads(cfg_path.read_text())
    cfg["trainer"].update(save_dir=str(tmp_path), epochs=1, init_val=False)
    change(cfg)
    out = tmp_path / "cfg.json"
    out.write_text(json.dumps(cfg))
    return cli.run(["-c", str(out), "--device", "cpu"])


def _buckets(cfg):
    cfg["trainer"]["text_buckets"] = [32, 48, 64]


def _mlm(cfg):
    cfg["mlm"] = {"weight": 0.5}


@pytest.mark.parametrize("path,change,key", [
    ("retrieval", _buckets, "trainer.text_buckets"),
    ("qa", _buckets, "trainer.text_buckets"),
    ("retrieval", _mlm, "mlm.weight"),
], ids=["buckets-retrieval", "buckets-qa", "mlm-retrieval"])
def test_unported_key_is_refused(tmp_path, path, change, key):
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        _run(tmp_path, path, change)
    assert not (tmp_path / "models").exists()  # refused before the run dir is made


@pytest.mark.parametrize("cfg", [
    {"trainer": {"text_buckets": []}, "mlm": {"weight": 0}},
    {"trainer": {"text_buckets": None}, "mlm": {"weight": 0.0, "mask_prob": 0.15}},
    {"trainer": {}},
], ids=["empty-zero", "none-zero", "absent"])
def test_absent_empty_or_zero_is_accepted(cfg):
    assert common.refuse_unported_keys(cfg) is None


def test_empty_buckets_and_zero_mlm_train_as_before(tmp_path):
    def change(cfg):
        cfg["trainer"]["text_buckets"] = []
        cfg["mlm"] = {"weight": 0}

    trainer = _run(tmp_path, "qa", change)
    assert len(trainer.step_losses) == 4  # 32 samples, batch 8
