"""Retrieval training on one card (counterpart of demovlp_tpu/cli/train.py).

    python -m demovlp_tpu_torch.cli.train -c <cfg> [-r <checkpoint.pth>] \\
        [-sc 30 40] [-lr1 2e-4] [--lr LR] [--bs B] [--seed 0] [--device cpu]

Runs `trainer.epochs` epochs of train steps (validation first when
`trainer.init_val`), validates after every epoch and saves a checkpoint
every epoch under `<trainer.save_dir>/models/<name>/<stamp>/`. `-r`, or
`trainer.resume` in the config ("auto": the newest checkpoint of this
config's runs), resumes weights, optimizer state and epoch. The weights
start from a seeded random init (--seed, which with the optimizer step
and the data rank also keys dropout), then
`arch.args.load_checkpoint` when set: a reference-schema `.pth` whose
temporal embed is resized to the config's frame count
(`arch.args.load_temporal_fix`: zeros, interp or bilinear), as an f = 8
fine-tune starts from an f = 1 pre-training checkpoint. Runs on the card
unless `--device cpu` is given; with no card it raises.
"""
from __future__ import annotations

from typing import Optional, Sequence

from demovlp_tpu_torch.cli.common import run_trainer
from demovlp_tpu_torch.train.retrieval import RetrievalTrainer


def run(argv: Optional[Sequence[str]] = None, fence_steps: bool = False) -> RetrievalTrainer:
    """Run the CLI; returns the trainer (its `final_log`, `step_losses` and,
    with `fence_steps`, `step_times` hold the run's record)."""
    return run_trainer(RetrievalTrainer, "retrieval training (PyTorch port)", "val", argv,
                       fence_steps)


if __name__ == "__main__":
    run()
