"""Retrieval training on one card (counterpart of demovlp_tpu/cli/train.py).

    python -m demovlp_tpu_torch.cli.train -c <cfg> [-r <checkpoint.pth>] \\
        [-sc 30 40] [-lr1 2e-4] [--lr LR] [--bs B] [--seed 0] [--device cpu]

Runs `trainer.epochs` epochs of train steps (validation first when
`trainer.init_val`), validates after every epoch and saves a checkpoint
every epoch under `<trainer.save_dir>/models/<name>/<stamp>/`. `-r`, or
`trainer.resume` in the config ("auto": the newest checkpoint of this
config's runs), resumes weights, optimizer state and epoch. The weights
start from a seeded random init (--seed, which also seeds dropout). Runs
on the card unless `--device cpu` is given; with no card it raises.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from demovlp_tpu_torch.cli.common import (build_loss, build_metrics, build_optimizer,
                                          build_tokenizer_from_config, build_train_model,
                                          compute_dtype, init_dataloaders)
from demovlp_tpu_torch.config import (apply_overrides, build_train_argparser,
                                      make_run_dir, read_config)
from demovlp_tpu_torch.device import resolve_device
from demovlp_tpu_torch.train.checkpoint import find_latest_checkpoint
from demovlp_tpu_torch.train.retrieval import RetrievalTrainer


def run(argv: Optional[Sequence[str]] = None, fence_steps: bool = False) -> RetrievalTrainer:
    """Run the CLI; returns the trainer (its `final_log`, `step_losses` and,
    with `fence_steps`, `step_times` hold the run's record)."""
    args = build_train_argparser("retrieval training (PyTorch port)").parse_args(argv)
    device = resolve_device(args.device)
    config = apply_overrides(read_config(args.config), args)
    torch.manual_seed(args.seed)  # dropout
    cfg_trainer = config["trainer"]
    save_dir = make_run_dir(config)
    train_loaders, val_loaders = init_dataloaders(config, val_split="val")
    model = build_train_model(config, device, seed=args.seed)
    bf16 = compute_dtype(config) == torch.bfloat16
    trainer = RetrievalTrainer(
        model, build_loss(config), build_metrics(config),
        build_optimizer(config, model.parameters()), config, save_dir, device,
        data_loader=train_loaders, valid_data_loader=val_loaders,
        tokenizer=build_tokenizer_from_config(config),
        max_samples_per_epoch=cfg_trainer.get("max_samples_per_epoch", 50000),
        transfer_dtype=torch.bfloat16 if bf16 else None, fence_steps=fence_steps,
        schedule=args.schedule, learning_rate1=args.learning_rate1,
        lr_mode=cfg_trainer.get("lr_mode", "reference"),
    )
    resume = args.resume or cfg_trainer.get("resume")
    if resume == "auto":
        resume = find_latest_checkpoint(cfg_trainer.get("save_dir", "exps"), config["name"])
    if resume:
        trainer.resume(resume)
    trainer.final_log = trainer.train()
    return trainer


if __name__ == "__main__":
    run()
