"""Trainer checkpoints (counterpart of demovlp_tpu/train/checkpoint.py).

Each epoch is saved with `torch.save` in the reference trainer's schema
(`_save_checkpoint`; the JAX package writes the same schema in
convert/torch_export.py): {arch, epoch, state_dict, optimizer, monitor_best,
config}, to `checkpoint-epoch{N}.pth`, and copied to `model_best.pth` when
the monitored metric improves. `state_dict` uses the reference key schema,
so the file also loads as weights (`-r` of the serving CLI, or the JAX
package's `load_reference_checkpoint`). A save writes a temporary file and
renames it, so a checkpoint is either complete or absent.

Across processes (JAX checkpoint.py:70,92): rank 0 writes, after every
rank has joined in gathering a tensor-parallel model's blocks whole, and
all ranks meet at a barrier before the save returns; every rank restores.
The file holds the reference layout (weights and AdamW moments whole), so
a checkpoint of a TP run loads into a model with no TP and back.
"""
from __future__ import annotations

import logging
import os
import re
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from demovlp_tpu_torch.parallel import tp
from demovlp_tpu_torch.parallel.mesh import is_main_process, sync_processes

logger = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"^checkpoint-epoch(\d+)\.pth$")


def _optimizer_state(model, optimizer, full: bool) -> Optional[dict]:
    """The optimizer's state dict with each tensor-parallel parameter's
    moments whole (`full`) or its state dict as it is (no TP)."""
    if optimizer is None:
        return None
    state = optimizer.state_dict()
    params = optimizer.param_groups[0]["params"]
    if not full:
        return state
    perms = tp.param_perms(model, params)
    for i, (p, perm) in enumerate(zip(params, perms)):
        st = state["state"].get(i)
        if st and isinstance(p, tp.DTensor):
            # a copy: the state dict shares its per-parameter dicts with the optimizer
            state["state"][i] = {**st, **{k: tp.full_tensor(p, st[k], perm).cpu()
                                          for k in ("mu", "nu")}}
    return state


def _load_optimizer(model, optimizer, state: dict) -> None:
    """Load a reference-layout optimizer state, cutting each tensor-parallel
    parameter's moments to this rank's block."""
    params = optimizer.param_groups[0]["params"]
    for i, (p, perm) in enumerate(zip(params, tp.param_perms(model, params))):
        st = state["state"].get(i)
        if st and isinstance(p, tp.DTensor):
            state["state"][i] = {**st, **{k: tp.local_block(p, st[k].to(p.to_local().device), perm)
                                          for k in ("mu", "nu")}}
    optimizer.load_state_dict(state)


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
        sharded = any(isinstance(p, tp.DTensor) for p in model.parameters())
        if sharded:  # a collective: every rank takes part
            weights = tp.full_state_dict(model)
        else:
            weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        opt_state = _optimizer_state(model, optimizer, sharded)
        if not is_main_process():
            sync_processes()
            return path
        state = {
            "arch": self.arch,
            "epoch": epoch,
            "state_dict": weights,
            "optimizer": opt_state,
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
        sync_processes()
        return path

    def restore(self, path, model: torch.nn.Module, optimizer=None) -> Dict[str, Any]:
        """Load weights (strict) and, when given, the optimizer state into
        place; returns the checkpoint's metadata (epoch, monitor_best, ...)."""
        ckpt = torch.load(Path(path), map_location="cpu", weights_only=True)
        if ckpt.get("arch") and self.arch and ckpt["arch"] != self.arch:
            logger.warning("Architecture in checkpoint (%s) differs from current (%s).",
                           ckpt["arch"], self.arch)
        tp.load_full_state_dict(model, ckpt["state_dict"])
        if optimizer is not None and ckpt.get("optimizer") is not None:
            _load_optimizer(model, optimizer, ckpt["optimizer"])
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
