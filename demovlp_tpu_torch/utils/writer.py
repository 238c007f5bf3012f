"""Scalar metric writer (counterpart of demovlp_tpu/utils/writer.py).

Duck-typed like the reference's TensorboardWriter: `.set_step(step, mode)`
then `.log_scalar(tag, value)`. Every scalar goes to `scalars.jsonl` in the
log dir, one JSON record a line {tag, value, step, t}; a TensorBoard sink
is attached as well where `torch.utils.tensorboard` imports. On a step
change the writer logs `steps_per_sec` over the wall time since the last
one. Values reach the writer as host floats: it never reads a device
tensor, so it adds no synchronisation with the card.

The JAX package's ExperimentWriter (its `trainer.neptune` sink) has no
counterpart: no CLI attaches an experiment backend to it, and with none
attached it writes what MetricsWriter writes, which is what a config that
sets `trainer.neptune` gets here.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional


class MetricsWriter:
    def __init__(self, log_dir, use_tensorboard: bool = True):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.log_dir / "scalars.jsonl", "a")
        self.step = 0
        self.mode = ""
        self._timer = time.time()
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # the tensorboard package is not installed
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(str(self.log_dir))

    def set_step(self, step: int, mode: str = "train") -> None:
        self.mode = mode
        if step == 0:
            self._timer = time.time()
        else:
            now = time.time()
            dt = now - self._timer
            if dt > 0:
                self.log_scalar("steps_per_sec", (step - self.step) / dt)
            self._timer = now
        self.step = step

    def log_scalar(self, tag: str, value, step: Optional[int] = None) -> None:
        step = self.step if step is None else step
        tag = f"{self.mode}/{tag}" if self.mode else tag
        rec = {"tag": tag, "value": float(value), "step": int(step), "t": time.time()}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def close(self) -> None:
        self._fh.close()
        if self._tb is not None:
            self._tb.close()
