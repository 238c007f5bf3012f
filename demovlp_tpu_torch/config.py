"""Experiment config (cut-down counterpart of demovlp_tpu/config.py).

Reads the repo's JSON experiment files (`configs/*.json`) as they are, as
plain dicts, and parses the command lines. `-r` names a reference-schema
`.pth`: weights for the serving CLI, a trainer checkpoint (weights,
optimizer state, epoch) for the train CLI; the port writes one file that
is both. The train CLI's overrides follow the JAX package: `--lr` ->
optimizer.args.lr, `--bs` -> data_loader.args.batch_size; `-sc` and `-lr1`
set the step-decay schedule. Each training run writes into three
directories of one stamp ($DEMOVLP_RUN_ID, else the time), as the JAX
package's ConfigParser lays them out under `<trainer.save_dir>`:
`models/<name>/<stamp>/` (checkpoints, a config.json snapshot),
`log/<name>/<stamp>/` (info.log, scalars.jsonl) and `web/<name>/<stamp>/`
(the retrieval visualizer's index.html).
"""
from __future__ import annotations

import argparse
import json
import os
from datetime import datetime
from pathlib import Path
from typing import Any, Dict

from demovlp_tpu_torch.utils.logging import setup_logging

# CLI overrides: flag name -> path into the config tree
OVERRIDES = {
    "lr": ("optimizer", "args", "lr"),
    "bs": ("data_loader", "args", "batch_size"),
}


def build_argparser(description: str = "demovlp_tpu_torch") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-c", "--config", required=True, type=str, help="config file path")
    p.add_argument("-r", "--resume", default=None, type=str,
                   help="reference-schema .pth (default: seeded random init)")
    p.add_argument("--device", default=None, type=str,
                   help="torch device (default cuda; 'cpu' runs on the CPU)")
    p.add_argument("--seed", type=int, default=0, help="seed of the random init")
    return p


def build_train_argparser(description: str = "demovlp_tpu_torch train") -> argparse.ArgumentParser:
    p = build_argparser(description)
    p.add_argument("-lr1", "--learning_rate1", type=float, default=2e-4)
    p.add_argument("-sc", "--schedule", type=int, nargs="+", default=[30, 40])
    p.add_argument("--lr", "--learning_rate", dest="lr", type=float, default=None)
    p.add_argument("--bs", "--batch_size", dest="bs", type=int, default=None)
    return p


def read_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def apply_overrides(config: Dict[str, Any], args: argparse.Namespace) -> Dict[str, Any]:
    for flag, keys in OVERRIDES.items():
        value = getattr(args, flag, None)
        if value is None:
            continue
        sections = config[keys[0]]
        for tree in sections if isinstance(sections, list) else [sections]:
            for k in keys[1:-1]:
                tree = tree[k]
            tree[keys[-1]] = value
    return config


def run_stamp() -> str:
    """The run's directory stamp: $DEMOVLP_RUN_ID, else the time."""
    return os.environ.get("DEMOVLP_RUN_ID", "") or datetime.now().strftime(r"%m%d_%H%M%S")


def make_run_dir(config: Dict[str, Any], stamp: str = "", main: bool = True) -> Path:
    """The run's checkpoint directory, created, with config.json in it; its
    log and web directories (`run_log_dir`, `run_web_dir`) are created too,
    and the root logger writes the log directory's info.log. Only the main
    process (rank 0) writes: the others get the path."""
    root = Path(config.get("trainer", {}).get("save_dir", "exps"))
    run_dir = root / "models" / config.get("name", "exp") / (stamp or run_stamp())
    if not main:
        return run_dir
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "config.json").write_text(json.dumps(config, indent=2))
    run_web_dir(run_dir).mkdir(parents=True, exist_ok=True)
    setup_logging(run_log_dir(run_dir))
    return run_dir


def _sibling(run_dir: Path, kind: str) -> Path:
    """<save_dir>/models/<name>/<stamp> -> <save_dir>/<kind>/<name>/<stamp>."""
    run_dir = Path(run_dir)
    return run_dir.parents[2] / kind / run_dir.parent.name / run_dir.name


def run_log_dir(run_dir) -> Path:
    """The log directory of the run whose checkpoint directory is `run_dir`."""
    return _sibling(run_dir, "log")


def run_web_dir(run_dir) -> Path:
    """The web directory of the run whose checkpoint directory is `run_dir`."""
    return _sibling(run_dir, "web")
