"""Fenced train-step times of the PyTorch port in several checkouts, on one card.

For each checkout root given, in the order given, a fresh process runs that
checkout's train CLI (`demovlp_tpu_torch.cli.train.run`, `fence_steps=True`)
for one epoch of configs/bench/ab_local_bf16.json at full width (16 steps of
128 pairs, as chip_smoke.py's [train] phase runs it) and prints one JSON line:
the root, the median step ms over steps 2-16 (the card fenced after each
step), their spread, every step's ms and, where the checkout has one, the
host time of the train step's dropout scope. Roots may repeat, so two checkouts
are compared in one call by alternating them (parent, change, change,
parent); the kernels build in each checkout's own `build/` on its first run.
The card's name and power limit are printed first.

    python scripts/torch_train_step_ab.py build/parent . . build/parent
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path


def _one(root: Path) -> None:
    """Run one epoch in this process from `root` and print its JSON line."""
    sys.path.insert(0, str(root))
    os.chdir(root)
    import numpy as np
    import torch

    import demovlp_tpu_torch
    from demovlp_tpu_torch.cli.train import run

    torch.zeros(1, device="cuda")
    scope_us = _scope_us()  # before the trainer's threads start
    cfg = json.loads((root / "configs" / "bench" / "ab_local_bf16.json").read_text())
    with tempfile.TemporaryDirectory(dir=root / "build") as tmp:
        cfg["trainer"].update(epochs=1, save_dir=tmp)
        path = Path(tmp) / "train.json"
        path.write_text(json.dumps(cfg))
        trainer = run(["-c", str(path)], fence_steps=True)
        torch.cuda.synchronize()
    ms = [1e3 * t for t in trainer.step_times]
    if len(ms) != 16 or not all(np.isfinite(trainer.step_losses)):
        raise SystemExit(f"{root}: expected 16 finite steps, got {len(ms)}: {trainer.step_losses}")
    rest = ms[1:]
    print(json.dumps({"root": str(root), "package": demovlp_tpu_torch.__file__,
                      "dropout_scope_us": scope_us, "median_ms": float(np.median(rest)),
                      "min_ms": min(rest), "max_ms": max(rest), "step_ms": ms,
                      "loss_1": trainer.step_losses[0], "loss_16": trainer.step_losses[-1]}),
          flush=True)


def _scope_us():
    """Host microseconds of one enter and exit of the train step's dropout
    scope on the card (a mean of 1000 after 10), where the checkout has
    one; taken before the trainer starts its loader threads."""
    import time

    import torch

    from demovlp_tpu_torch.train import steps

    if not hasattr(steps, "dropout_scope"):
        return None
    make = steps.dropout_scope(0, 0, lambda: 7, False)
    device = torch.device("cuda")
    for _ in range(10):
        with make(device):
            pass
    t0 = time.perf_counter()
    for _ in range(1000):
        with make(device):
            pass
    return (time.perf_counter() - t0) * 1e3


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        _one(Path(argv[1]).resolve())
        return 0
    if not argv:
        raise SystemExit(__doc__)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    for root in argv:
        root = Path(root).resolve()
        (root / "build").mkdir(exist_ok=True)
        rc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one",
                             str(root)], cwd=root).returncode
        if rc != 0:
            print(f"{root}: exit {rc}", flush=True)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
