"""Kill and resume, the port's counterpart of tests/test_preemption.py, on
the CPU: the smoke retrieval config (dropout on, as the train CLI runs it)
for 2 epochs of 4 steps, in subprocesses (tests/torch_preempt_child.py).

* An uninterrupted run; a run killed with SIGKILL in epoch 2, after epoch
  1's checkpoint is committed, then the same command again with
  `trainer.resume: "auto"`, with the asynchronous save on and off: the
  relaunch trains epoch 2 only and its epoch-2 checkpoint equals the
  uninterrupted run's bit for bit (weights, AdamW moments and count). That
  holds because the dropout generator is keyed by the optimizer's restored
  update count (train/steps.py) and the loader by (seed, epoch).
* A run killed during the asynchronous write of epoch 2, with half of the
  temporary file on disk: the relaunch ignores the `.tmp`, resumes from
  epoch 1 and ends as above.
* The dropout keys: the masks of one (seed, step, rank) repeat, and another
  step or rank draws other masks.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from demovlp_tpu_torch.train.steps import dropout_key, dropout_scope

ROOT = Path(__file__).resolve().parents[1]
CHILD = ROOT / "tests" / "torch_preempt_child.py"
STEPS = 4  # a smoke epoch
TIMEOUT = 240


def _config(tmp_path: Path, tag: str, async_save: bool = True) -> Path:
    cfg = json.loads((ROOT / "configs" / "smoke" / "synthetic_retrieval.json").read_text())
    cfg["name"] = f"Preempt_{tag}"
    cfg["trainer"].update(save_dir=str(tmp_path / tag), epochs=2, init_val=False,
                          resume="auto", async_checkpoint=async_save)
    path = tmp_path / f"{tag}.json"
    path.write_text(json.dumps(cfg))
    return path


def _launch(cfg: Path, stamp: str, *opts) -> subprocess.Popen:
    env = dict(os.environ, DEMOVLP_RUN_ID=stamp, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    log = open(cfg.with_suffix(f".{stamp}.log"), "w")
    try:
        return subprocess.Popen([sys.executable, str(CHILD), str(cfg), *opts], cwd=ROOT, env=env,
                                stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()


def _finish(proc: subprocess.Popen, cfg: Path, stamp: str) -> str:
    try:
        rc = proc.wait(timeout=TIMEOUT)
    finally:
        proc.kill()
        proc.wait()
    text = cfg.with_suffix(f".{stamp}.log").read_text()
    assert rc == 0, text[-4000:]
    return text


def _run_dir(cfg: Path, stamp: str) -> Path:
    c = json.loads(cfg.read_text())
    return Path(c["trainer"]["save_dir"]) / "models" / c["name"] / stamp


def _kill_when(proc: subprocess.Popen, cfg: Path, stamp: str, *paths: Path) -> None:
    """SIGKILL once the child hangs and every path exists."""
    marker = Path(str(cfg) + ".hung")
    deadline = time.monotonic() + TIMEOUT
    try:
        while not (marker.exists() and all(p.exists() for p in paths)):
            assert proc.poll() is None, cfg.with_suffix(f".{stamp}.log").read_text()[-4000:]
            assert time.monotonic() < deadline, "the child never reached its hang"
            time.sleep(0.05)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    marker.unlink()


def _assert_same_state(got: Path, want: Path) -> None:
    a = torch.load(got, map_location="cpu", weights_only=True)
    b = torch.load(want, map_location="cpu", weights_only=True)
    assert a["epoch"] == b["epoch"] == 2
    assert a["state_dict"].keys() == b["state_dict"].keys()
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i, st in sa.items():
        assert st["count"] == sb[i]["count"] == 2 * STEPS
        assert torch.equal(st["mu"], sb[i]["mu"]) and torch.equal(st["nu"], sb[i]["nu"]), i


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory) -> Path:
    tmp = tmp_path_factory.mktemp("ref")
    cfg = _config(tmp, "ref")
    _finish(_launch(cfg, "ref"), cfg, "ref")
    ckpt = _run_dir(cfg, "ref") / "checkpoint-epoch2.pth"
    assert ckpt.exists()
    return ckpt


def _resume_and_check(cfg: Path, uninterrupted: Path) -> None:
    text = _finish(_launch(cfg, "run2"), cfg, "run2")
    assert "Resumed from" in text and "checkpoint-epoch1.pth" in text
    run2 = _run_dir(cfg, "run2")
    assert not (run2 / "checkpoint-epoch1.pth").exists()  # epoch 2 only
    _assert_same_state(run2 / "checkpoint-epoch2.pth", uninterrupted)


@pytest.mark.parametrize("async_save", [True, False], ids=["async", "blocking"])
def test_kill_after_epoch1_commit_and_resume(tmp_path, uninterrupted, async_save):
    cfg = _config(tmp_path, "vic", async_save)
    run1 = _run_dir(cfg, "run1")
    proc = _launch(cfg, "run1", "--hang-after-step", str(STEPS + 2))
    _kill_when(proc, cfg, "run1", run1 / "checkpoint-epoch1.pth")
    assert not (run1 / "checkpoint-epoch2.pth").exists()
    _resume_and_check(cfg, uninterrupted)


def test_kill_during_async_write_and_resume(tmp_path, uninterrupted):
    cfg = _config(tmp_path, "write")
    run1 = _run_dir(cfg, "run1")
    proc = _launch(cfg, "run1", "--hang-in-write", "2")
    _kill_when(proc, cfg, "run1", run1 / "checkpoint-epoch1.pth")
    assert list(run1.glob("checkpoint-epoch2.*.tmp")) and not (
        run1 / "checkpoint-epoch2.pth").exists()
    _resume_and_check(cfg, uninterrupted)


def test_dropout_masks_follow_the_key():
    model = torch.nn.Sequential(torch.nn.Dropout(0.5), torch.nn.Dropout(0.5)).train()
    x = torch.ones(4, 64)
    step = {"n": 0}

    def masks(seed, rank):
        before = torch.get_rng_state()
        with dropout_scope(seed, rank, lambda: step["n"], False)(x.device):
            out = model(x)
        assert torch.equal(torch.get_rng_state(), before)  # the global stream is restored
        return out

    first = masks(0, 0)
    assert torch.equal(masks(0, 0), first)
    assert not torch.equal(masks(0, 1), first) and not torch.equal(masks(1, 0), first)
    step["n"] = 1
    assert not torch.equal(masks(0, 0), first)
    assert len({dropout_key(s, n, r) for s in (0, 1) for n in (0, 1) for r in (0, 1)}) == 8
    torch.manual_seed(123)
    with dropout_scope(0, 0, lambda: 0, True)(x.device):  # deterministic: the stream is untouched
        unkeyed = model(x)
    torch.manual_seed(123)
    assert torch.equal(unkeyed, model(x))
