"""Multiple-choice evaluation on one card (counterpart of
demovlp_tpu/cli/train_mc.py; eval only, the configs set epochs 0).

    python -m demovlp_tpu_torch.cli.train_mc -c <cfg> [-r <checkpoint.pth>] \\
        [--seed 0] [--device cpu]

Scores each item's options by global + local similarity (the local part
through the f32 forward kernel on the card), `trainer.mc_eval_batch` items
a call (default 8; 1 is the batch-1 path), over the 'test' split, and
reports `evaluate_mc`. Weights: `-r`, `arch.args.load_checkpoint` (with the
temporal-embed resize of cli/train.py) or the seeded random init.
"""
from __future__ import annotations

from typing import Optional, Sequence

from demovlp_tpu_torch.cli.common import run_trainer
from demovlp_tpu_torch.train.mc import MCTrainer


def run(argv: Optional[Sequence[str]] = None) -> MCTrainer:
    return run_trainer(MCTrainer, "multiple-choice evaluation (PyTorch port)", "test", argv)


if __name__ == "__main__":
    run()
