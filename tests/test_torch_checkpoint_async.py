"""The asynchronous checkpoint (train/checkpoint.py, `trainer.async_checkpoint`)
on the CPU, on a small model with the port's AdamW after two updates:

* the asynchronous and the blocking save write files that load to equal
  tensors (weights, moments, count, metadata);
* a snapshot is taken before `save()` returns: an optimizer step that
  updates the parameters and moments in place while the writer is held
  does not reach the file;
* an exception on the writer thread surfaces at `wait()`, once, and no
  `.pth` is committed;
* `find_latest_checkpoint` ignores a `.tmp` (a write that never committed),
  and `latest()` waits for the write in flight;
* the trainer's default is asynchronous, `trainer.async_checkpoint: false`
  blocking, and the train CLI returns only after the last write.
"""
from __future__ import annotations

import json
import threading
from pathlib import Path

import pytest
import torch

from demovlp_tpu_torch.cli import train as train_cli
from demovlp_tpu_torch.train import checkpoint as ck
from demovlp_tpu_torch.train.base_trainer import BaseTrainer
from demovlp_tpu_torch.train.optim import AdamW

ROOT = Path(__file__).resolve().parents[1]


def _trained(steps: int = 2):
    model = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.LayerNorm(5), torch.nn.Linear(5, 3))
    gen = torch.Generator().manual_seed(0)
    for p in model.parameters():
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=gen))
    opt = AdamW(model.parameters(), lr=1e-2, weight_decay=0.01)
    for _ in range(steps):
        _step(model, opt, gen)
    return model, opt, gen


def _step(model, opt, gen):
    opt.zero_grad()
    model(torch.randn(4, 6, generator=gen)).square().sum().backward()
    opt.step()


def _assert_same(a: dict, b: dict) -> None:
    assert {k: v for k, v in a.items() if k not in ("state_dict", "optimizer")} == {
        k: v for k, v in b.items() if k not in ("state_dict", "optimizer")}
    assert a["state_dict"].keys() == b["state_dict"].keys()
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys() and a["optimizer"]["param_groups"] == b["optimizer"][
        "param_groups"]
    for i, st in sa.items():
        assert st["count"] == sb[i]["count"]
        assert torch.equal(st["mu"], sb[i]["mu"]) and torch.equal(st["nu"], sb[i]["nu"])


def _load(path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def test_async_and_blocking_files_hold_equal_tensors(tmp_path):
    model, opt, _ = _trained()
    paths = []
    for mode in (True, False):
        mgr = ck.CheckpointManager(tmp_path / str(mode), arch="Seq", config={"name": "x"},
                                   async_save=mode)
        paths.append(mgr.save(model, opt, 3, 0.5, save_best=True))
        mgr.wait()
        assert set(mgr.last_save) == {"stall_s", "write_s"}
        _assert_same(_load(paths[-1]), _load(paths[-1].with_name("model_best.pth")))
    _assert_same(_load(paths[0]), _load(paths[1]))
    assert _load(paths[0])["epoch"] == 3


def test_snapshot_is_not_reached_by_the_next_step(tmp_path, monkeypatch):
    model, opt, gen = _trained()
    want = {"state_dict": {k: v.clone() for k, v in model.state_dict().items()},
            "optimizer": {"state": {i: {k: (v.clone() if torch.is_tensor(v) else v)
                                        for k, v in st.items()}
                                    for i, st in opt.state_dict()["state"].items()}}}
    release, started = threading.Event(), threading.Event()
    save = torch.save

    def held(obj, f):
        started.set()
        assert release.wait(30)
        save(obj, f)

    monkeypatch.setattr(ck.torch, "save", held)
    mgr = ck.CheckpointManager(tmp_path, async_save=True)
    path = mgr.save(model, opt, 1, 0.0)
    assert started.wait(30) and not path.exists()
    _step(model, opt, gen)  # in place: the parameters, nu; mu replaced
    release.set()
    mgr.wait()
    got = _load(path)
    for k, v in want["state_dict"].items():
        assert torch.equal(got["state_dict"][k], v) and not torch.equal(
            model.state_dict()[k], v), k
    for i, st in want["optimizer"]["state"].items():
        for k in ("mu", "nu"):
            assert torch.equal(got["optimizer"]["state"][i][k], st[k])
        assert got["optimizer"]["state"][i]["count"] == 2


def test_writer_exception_surfaces_at_wait(tmp_path, monkeypatch):
    model, opt, _ = _trained(1)

    def failing(obj, f):
        raise OSError("disk full")

    monkeypatch.setattr(ck.torch, "save", failing)
    mgr = ck.CheckpointManager(tmp_path, async_save=True)
    path = mgr.save(model, opt, 1, 0.0)  # returns: the write runs on the thread
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()  # raised once
    assert not path.exists()
    with pytest.raises(OSError, match="disk full"):  # the blocking save raises in save()
        ck.CheckpointManager(tmp_path, async_save=False).save(model, opt, 1, 0.0)


def test_latest_ignores_tmp_and_waits_for_the_write(tmp_path, monkeypatch):
    model, opt, _ = _trained(1)
    run = tmp_path / "models" / "Exp" / "0101_000000"
    mgr = ck.CheckpointManager(run, async_save=False)
    mgr.save(model, opt, 1, 0.0)
    (run / "checkpoint-epoch2.4242.tmp").write_bytes(b"half a checkpoint")
    assert ck.find_latest_checkpoint(tmp_path, "Exp") == run / "checkpoint-epoch1.pth"
    release = threading.Event()
    save = torch.save
    monkeypatch.setattr(ck.torch, "save", lambda obj, f: (release.wait(30), save(obj, f)))
    mgr.async_save = True
    mgr.save(model, opt, 3, 0.0)
    assert ck.find_latest_checkpoint(tmp_path, "Exp") == run / "checkpoint-epoch1.pth"
    threading.Timer(0.2, release.set).start()
    assert mgr.latest(tmp_path, "Exp") == run / "checkpoint-epoch3.pth"


@pytest.mark.parametrize("value,want", [(None, True), (True, True), (False, False)],
                         ids=["default", "true", "false"])
def test_trainer_reads_async_checkpoint(tmp_path, value, want):
    cfg = {"trainer": {"epochs": 1}, "optimizer": {"args": {}}}
    if value is not None:
        cfg["trainer"]["async_checkpoint"] = value
    trainer = BaseTrainer(torch.nn.Linear(2, 2), None, [], None, cfg, tmp_path)
    assert trainer.checkpoint.async_save is want


def test_cli_returns_after_the_last_write(tmp_path, monkeypatch):
    cfg = json.loads((ROOT / "configs" / "smoke" / "synthetic_retrieval.json").read_text())
    cfg["trainer"].update(save_dir=str(tmp_path), epochs=2, init_val=False)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    write = ck.CheckpointManager._write
    writers = []

    def slow(self, *args):
        writers.append(threading.current_thread())
        threading.Event().wait(0.3)
        write(self, *args)

    monkeypatch.setattr(ck.CheckpointManager, "_write", slow)
    trainer = train_cli.run(["-c", str(path), "--device", "cpu"])
    assert len(writers) == 2 and all(t is not threading.main_thread() for t in writers)
    for epoch in (1, 2):
        assert (trainer.checkpoint.save_dir / f"checkpoint-epoch{epoch}.pth").exists()
    assert len(trainer.epoch_times) == 2
    assert set(trainer.checkpoint.last_save) == {"stall_s", "write_s"}
