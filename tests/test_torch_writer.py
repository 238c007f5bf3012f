"""The run's record on the CPU: the port's MetricsWriter against the JAX
package's MetricsWriter and its ExperimentWriter as its CLIs build it (no
experiment attached, under `trainer.neptune`) on the same call sequences;
and what the port's
train CLIs leave in `<save_dir>/log/<name>/<stamp>/` (scalars.jsonl,
info.log) and `<save_dir>/web/<name>/<stamp>/` (index.html with a
visualizer), with the JAX trainers' tags and steps: `train/loss_train_0`
at the optimizer's update count (1 at a fresh run's first step, carried
on over a resume), valued as the trainer's own `step_losses`;
`loss_val_0` after each validation (untagged at init_val, under `train/`
after training); QA logs train losses only, MC nothing. The step count
is AdamW's update count, which a state dict carries."""
from __future__ import annotations

import json
import types
from pathlib import Path

import pytest

from demovlp_tpu.utils import writer as jwriter
from demovlp_tpu_torch.cli import train, train_mc, train_qa
from demovlp_tpu_torch.utils import writer as twriter

ROOT = Path(__file__).resolve().parents[1]


def _clock(start=100.0, tick=0.25):
    t = [start]

    def now():
        t[0] += tick
        return t[0]

    return now


# call sequences: a fresh run's train and val steps; and a resumed run's,
# starting at step 5 and setting one step twice
_SEQUENCES = {
    "fresh": [("log", "loss_val_0", 3.5), ("step", 1, "train"), ("log", "loss_train_0", 2.0),
              ("step", 2, "train"), ("log", "loss_train_0", 1.75), ("step", 4, "val"),
              ("log", "loss_val_0", 1.5, 7), ("step", 0, ""), ("log", "plain", 0.5)],
    "resumed": [("step", 5, "train"), ("log", "loss_train_0", 1.25), ("step", 5, "train"),
                ("log", "loss_train_0", 1.0), ("step", 6, "train"), ("log", "loss_val_0", 0.5)],
}


def _drive(module, cls, log_dir, monkeypatch, sequence):
    """One call sequence through `cls`; the records without the time field."""
    monkeypatch.setattr(module, "time", types.SimpleNamespace(time=_clock()))
    w = getattr(module, cls)(log_dir, use_tensorboard=False)
    for call, *args in _SEQUENCES[sequence]:
        (w.set_step if call == "step" else w.log_scalar)(*args)
    w.close()
    lines = (Path(log_dir) / "scalars.jsonl").read_text().splitlines()
    recs = [json.loads(line) for line in lines]
    assert all(set(r) == {"tag", "value", "step", "t"} for r in recs)
    return [(r["tag"], r["value"], r["step"]) for r in recs]


@pytest.mark.parametrize("sequence", sorted(_SEQUENCES))
@pytest.mark.parametrize("cls", ["MetricsWriter", "ExperimentWriter"])
def test_writer_records_match_jax(cls, sequence, tmp_path, monkeypatch):
    got = _drive(twriter, "MetricsWriter", tmp_path / "port", monkeypatch, sequence)
    want = _drive(jwriter, cls, tmp_path / "jax", monkeypatch, sequence)
    assert got == want
    tags = [t for t, _, _ in got]
    if sequence == "fresh":
        assert tags.count("train/steps_per_sec") == 2 and "val/steps_per_sec" in tags
        assert ("val/loss_val_0", 1.5, 7) in got and ("plain", 0.5, 0) in got
    else:
        # the rate is logged before the step moves on, at the step before
        assert got[:2] == [("train/steps_per_sec", 5 / 0.25, 0), ("train/loss_train_0", 1.25, 5)]
        assert ("train/steps_per_sec", 0.0, 5) in got


def test_step_count_is_the_update_count_and_survives_a_state_dict():
    import torch

    from demovlp_tpu_torch.train.optim import AdamW

    p = torch.nn.Parameter(torch.ones(3))
    opt = AdamW([p], lr=0.1)
    assert opt.step_count == 0 and len(opt.state) == 0
    for _ in range(3):
        p.grad = torch.ones(3)
        opt.step()
    assert opt.step_count == 3
    restored = AdamW([torch.nn.Parameter(torch.ones(3))], lr=0.1)
    restored.load_state_dict(opt.state_dict())
    assert restored.step_count == 3


def _config(tmp_path, name, epochs=1, visualizer="", neptune=False):
    """The smoke config `name` saving under tmp_path; `trainer.neptune`
    set when `neptune` (the JAX CLIs' ExperimentWriter switch, which
    changes no record)."""
    cfg = json.loads((ROOT / "configs" / "smoke" / name).read_text())
    cfg["trainer"].update(save_dir=str(tmp_path), epochs=epochs)
    if neptune:
        cfg["trainer"]["neptune"] = True
    cfg["visualizer"] = {"type": visualizer, "args": {"num_samples": 4}}
    path = tmp_path / f"{epochs}-{name}"
    path.write_text(json.dumps(cfg))
    return cfg, path


def _records(tmp_path, cfg, stamp):
    log_dir = tmp_path / "log" / cfg["name"] / stamp
    lines = (log_dir / "scalars.jsonl").read_text().splitlines()
    return log_dir, [json.loads(line) for line in lines]


def _train_losses(recs):
    return [(r["step"], r["value"]) for r in recs if r["tag"] == "train/loss_train_0"]


@pytest.mark.parametrize("neptune", [False, True])
def test_retrieval_cli_writes_the_run_record(tmp_path, monkeypatch, neptune):
    monkeypatch.setenv("DEMOVLP_RUN_ID", "rec1")
    cfg, path = _config(tmp_path, "synthetic_retrieval.json", neptune=neptune)
    trainer = train.run(["-c", str(path), "--device", "cpu"])
    log_dir, recs = _records(tmp_path, cfg, "rec1")
    n = len(trainer.step_losses)
    assert n == 4
    assert _train_losses(recs) == list(zip(range(1, n + 1), trainer.step_losses))
    val = [(r["tag"], r["step"]) for r in recs if r["tag"].endswith("loss_val_0")]
    assert val == [("loss_val_0", 0), ("train/loss_val_0", n)]
    assert [r["value"] for r in recs if r["tag"] == "train/loss_val_0"] == [
        trainer.final_log["val_loss_0"]]
    info = (log_dir / "info.log").read_text()
    assert "val_loss_0" in info and "epoch" in info
    assert (tmp_path / "web" / cfg["name"] / "rec1").is_dir()
    assert not (tmp_path / "web" / cfg["name"] / "rec1" / "index.html").exists()
    assert trainer.writer.log_dir == log_dir


def test_retrieval_resume_carries_the_step_count_on(tmp_path, monkeypatch):
    monkeypatch.setenv("DEMOVLP_RUN_ID", "first")
    cfg, path = _config(tmp_path, "synthetic_retrieval.json")
    first = train.run(["-c", str(path), "--device", "cpu"])
    ckpt = first.checkpoint.save_dir / "checkpoint-epoch1.pth"
    monkeypatch.setenv("DEMOVLP_RUN_ID", "second")
    cfg2, path2 = _config(tmp_path, "synthetic_retrieval.json", epochs=2)
    second = train.run(["-c", str(path2), "-r", str(ckpt), "--device", "cpu"])
    _, recs = _records(tmp_path, cfg2, "second")
    assert second.optimizer.step_count == 8
    assert _train_losses(recs) == list(zip(range(5, 9), second.step_losses))


def test_retrieval_cli_with_a_visualizer_writes_index_html(tmp_path, monkeypatch):
    monkeypatch.setenv("DEMOVLP_RUN_ID", "vis1")
    cfg, path = _config(tmp_path, "synthetic_retrieval.json", visualizer="RetrievalVis")
    train.run(["-c", str(path), "--device", "cpu"])
    page = (tmp_path / "web" / cfg["name"] / "vis1" / "index.html").read_text()
    assert page.startswith("<!DOCTYPE html>")
    assert "epoch [1]" in page and "synthetic://" in page and "R1: " in page


def test_unported_visualizer_is_refused(tmp_path, monkeypatch):
    monkeypatch.setenv("DEMOVLP_RUN_ID", "vis2")
    _, path = _config(tmp_path, "synthetic_retrieval.json", visualizer="NoSuchVis")
    with pytest.raises(NotImplementedError, match="NoSuchVis"):
        train.run(["-c", str(path), "--device", "cpu"])


def test_qa_cli_writes_train_losses(tmp_path, monkeypatch):
    monkeypatch.setenv("DEMOVLP_RUN_ID", "qa1")
    cfg, path = _config(tmp_path, "synthetic_qa.json")
    trainer = train_qa.run(["-c", str(path), "--device", "cpu"])
    log_dir, recs = _records(tmp_path, cfg, "qa1")
    n = len(trainer.step_losses)
    assert n > 0
    assert _train_losses(recs) == list(zip(range(1, n + 1), trainer.step_losses))
    assert {r["tag"] for r in recs} == {"train/loss_train_0", "train/steps_per_sec"}
    assert (log_dir / "info.log").is_file()
    assert (tmp_path / "web" / cfg["name"] / "qa1").is_dir()


def test_mc_cli_creates_the_run_dirs_and_logs_no_scalar(tmp_path, monkeypatch):
    monkeypatch.setenv("DEMOVLP_RUN_ID", "mc1")
    cfg, path = _config(tmp_path, "synthetic_mc.json", epochs=0)
    train_mc.run(["-c", str(path), "--device", "cpu"])
    log_dir, recs = _records(tmp_path, cfg, "mc1")
    assert recs == []
    assert (log_dir / "info.log").is_file()
    assert (tmp_path / "web" / cfg["name"] / "mc1").is_dir()
