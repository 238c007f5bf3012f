"""A run of the port's train CLI that a test kills (tests/test_torch_preemption.py).

    python tests/torch_preempt_child.py <config.json> [--hang-after-step N | --hang-in-write E]

Without an option it is `python -m demovlp_tpu_torch.cli.train -c <config>
--device cpu`, less the TensorBoard sink (where TensorFlow is installed,
importing the sink pulls it in, seconds a process; the test reads
checkpoints, not event files). `--hang-after-step N` stops the run after its N-th train
step (the optimizer's update count), `--hang-in-write E` inside the write
of epoch E's checkpoint, once half of its temporary file is on disk; either
then touches `<config>.hung` and sleeps until it is killed.
"""
from __future__ import annotations

import functools
import os
import sys
import time
from pathlib import Path


def _hang(marker: Path) -> None:
    marker.touch()
    while True:
        time.sleep(1)


def main() -> None:
    cfg, opts = sys.argv[1], sys.argv[2:]
    marker = Path(cfg + ".hung")
    import torch

    from demovlp_tpu_torch.cli import common, train
    from demovlp_tpu_torch.train import checkpoint, retrieval

    common.MetricsWriter = functools.partial(common.MetricsWriter, use_tensorboard=False)

    if opts[:1] == ["--hang-after-step"]:
        after = int(opts[1])
        make = retrieval.make_retrieval_train_step

        def make_hanging(model, loss, optimizer, **kw):
            step = make(model, loss, optimizer, **kw)

            def hanging(batch, lr):
                out = step(batch, lr)
                if optimizer.step_count == after:
                    _hang(marker)
                return out

            return hanging

        retrieval.make_retrieval_train_step = make_hanging
    elif opts[:1] == ["--hang-in-write"]:
        name = f"checkpoint-epoch{int(opts[1])}.pth"
        write = checkpoint.CheckpointManager._write

        def hanging_write(self, state, path, save_best, rec):
            if path.name != name:
                return write(self, state, path, save_best, rec)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            torch.save(state, tmp)
            os.truncate(tmp, tmp.stat().st_size // 2)
            _hang(marker)

        checkpoint.CheckpointManager._write = hanging_write
    elif opts:
        raise SystemExit(f"unknown options {opts}")
    train.run(["-c", cfg, "--device", "cpu"])


if __name__ == "__main__":
    main()
