"""Trainer checkpoints (counterpart of demovlp_tpu/train/checkpoint.py).

Each epoch is saved with `torch.save` in the reference trainer's schema
(`_save_checkpoint`; the JAX package writes the same schema in
convert/torch_export.py): {arch, epoch, state_dict, optimizer, monitor_best,
config}, to `checkpoint-epoch{N}.pth`, and copied to `model_best.pth` when
the monitored metric improves. `state_dict` uses the reference key schema,
so the file also loads as weights (`-r` of the serving CLI, or the JAX
package's `load_reference_checkpoint`). A save writes a temporary file and
renames it, so a checkpoint is either complete or absent.
"""
from __future__ import annotations

import logging
import os
import re
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import torch

logger = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"^checkpoint-epoch(\d+)\.pth$")


def _epochs(run_dir: Path):
    """(epoch, path) of the run directory's checkpoints, oldest first."""
    found = []
    for p in run_dir.glob("checkpoint-epoch*.pth"):
        m = _CKPT_RE.match(p.name)
        if m:
            found.append((int(m.group(1)), p))
    return sorted(found)


class CheckpointManager:
    def __init__(self, save_dir, arch: str = "", config: Optional[dict] = None):
        self.save_dir = Path(save_dir).absolute()
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.arch = arch
        self.config = config or {}

    def save(self, model: torch.nn.Module, optimizer, epoch: int, monitor_best: float,
             save_best: bool = False) -> Path:
        path = self.save_dir / f"checkpoint-epoch{epoch}.pth"
        state = {
            "arch": self.arch,
            "epoch": epoch,
            "state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "optimizer": optimizer.state_dict() if optimizer is not None else None,
            "monitor_best": float(monitor_best),
            "config": self.config,
        }
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save(state, tmp)
        os.replace(tmp, path)
        logger.info("Saving checkpoint: %s ...", path)
        if save_best:
            best = self.save_dir / "model_best.pth"
            shutil.copyfile(path, best.with_suffix(".tmp"))
            os.replace(best.with_suffix(".tmp"), best)
            logger.info("Saving current best: model_best.pth ...")
        return path

    def restore(self, path, model: torch.nn.Module, optimizer=None) -> Dict[str, Any]:
        """Load weights (strict) and, when given, the optimizer state into
        place; returns the checkpoint's metadata (epoch, monitor_best, ...)."""
        ckpt = torch.load(Path(path), map_location="cpu", weights_only=True)
        if ckpt.get("arch") and self.arch and ckpt["arch"] != self.arch:
            logger.warning("Architecture in checkpoint (%s) differs from current (%s).",
                           ckpt["arch"], self.arch)
        model.load_state_dict(ckpt["state_dict"], strict=True)
        if optimizer is not None and ckpt.get("optimizer") is not None:
            optimizer.load_state_dict(ckpt["optimizer"])
        return {k: v for k, v in ckpt.items() if k not in ("state_dict", "optimizer")}


def find_latest_checkpoint(save_root, exper_name: str) -> Optional[Path]:
    """Newest checkpoint across a config's timestamped run directories
    (`<save_root>/models/<name>/<stamp>/`), newest run first: what
    `trainer.resume: "auto"` resumes from."""
    base = Path(save_root) / "models" / exper_name
    if not base.exists():
        return None
    for run_dir in sorted((p for p in base.iterdir() if p.is_dir()), reverse=True):
        found = _epochs(run_dir)
        if found:
            return found[-1][1]
    return None
