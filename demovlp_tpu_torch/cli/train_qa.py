"""Video-QA training on one card (counterpart of demovlp_tpu/cli/train_qa.py).

    python -m demovlp_tpu_torch.cli.train_qa -c <cfg> [-r <checkpoint.pth>] \\
        [-sc 30 40] [-lr1 2e-4] [--lr LR] [--bs B] [--seed 0] [--device cpu]

Options, checkpoints, `arch.args.load_checkpoint` and the device rule as in
cli/train.py. The val loaders read the 'test' split, as the reference does;
validation reports `evaluate_qa` (overall and per-answer-type accuracy).
"""
from __future__ import annotations

from typing import Optional, Sequence

from demovlp_tpu_torch.cli.common import run_trainer
from demovlp_tpu_torch.train.qa import QATrainer


def run(argv: Optional[Sequence[str]] = None, fence_steps: bool = False) -> QATrainer:
    return run_trainer(QATrainer, "video-QA training (PyTorch port)", "test", argv,
                       fence_steps)


if __name__ == "__main__":
    run()
