"""Trainer checkpoints (counterpart of demovlp_tpu/train/checkpoint.py).

Each epoch is saved with `torch.save` in the reference trainer's schema
(`_save_checkpoint`; the JAX package writes the same schema in
convert/torch_export.py): {arch, epoch, state_dict, optimizer, monitor_best,
config}, to `checkpoint-epoch{N}.pth`, and copied to `model_best.pth` when
the monitored metric improves. `state_dict` uses the reference key schema,
so the file also loads as weights (`-r` of the serving CLI, or the JAX
package's `load_reference_checkpoint`). A save writes a temporary file
(`checkpoint-epoch{N}.<pid>.tmp`) and renames it: the rename is the commit,
so a checkpoint is either complete or absent, and `find_latest_checkpoint`
(`trainer.resume: "auto"`) never picks up a half-written file.

Asynchronous save (`trainer.async_checkpoint`, true by default, as in JAX
checkpoint.py): `save()` takes a host copy of the weights and of the
optimizer state (the foreach AdamW updates the parameters and moments in
place, so the copy is what makes the file the epoch's state), joins a
tensor-parallel gather where the model is split, meets the barrier and
returns; a writer thread on rank 0 then writes and commits the file and
copies `model_best.pth`. The thread reads only those host tensors. `wait()`
joins it, meets the other ranks at a barrier (the file is then there for
every rank) and re-raises the thread's exception; it runs before the next
save, before a restore or `latest()`, at the end of training and in the
CLIs before they exit. The thread is a daemon, so an exit that skips
`wait()` loses the file being written. With `async_save=False` `save()`
calls `wait()` itself before it returns: the same write, on the same
thread, only not overlapped with training.
`saves` holds each save's readings (`last_save` the last one's):
`stall_s`, the calling thread's time from the call to the return (waiting
for the previous write included), and `write_s` on rank 0, the write's own
time on the thread that wrote (set when the write ends).

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
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from demovlp_tpu_torch.parallel import tp
from demovlp_tpu_torch.parallel.mesh import is_main_process, sync_processes

logger = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"^checkpoint-epoch(\d+)\.pth$")


def _host_copy(obj):
    """`obj` with every tensor copied to the host and every dict and list
    rebuilt: shares nothing that a later step updates in place."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _optimizer_state(model, optimizer, full: bool) -> Optional[dict]:
    """A host copy of the optimizer's state dict, each tensor-parallel
    parameter's moments whole (`full`, a collective)."""
    if optimizer is None:
        return None
    state = optimizer.state_dict()
    params = optimizer.param_groups[0]["params"]
    if full:
        perms = tp.param_perms(model, params)
        for i, (p, perm) in enumerate(zip(params, perms)):
            st = state["state"].get(i)
            if st and isinstance(p, tp.DTensor):
                state["state"][i] = {**st, **{k: tp.full_tensor(p, st[k], perm)
                                              for k in ("mu", "nu")}}
    return _host_copy(state)


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
    def __init__(self, save_dir, arch: str = "", config: Optional[dict] = None,
                 async_save: bool = True):
        self.save_dir = Path(save_dir).absolute()
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.arch = arch
        self.config = config or {}
        self.async_save = async_save
        self.saves: List[Dict[str, float]] = []
        self._writer: Optional[threading.Thread] = None
        self._writer_exc: Optional[Exception] = None
        self._pending = False  # a save not yet waited for (every rank)

    @property
    def last_save(self) -> Dict[str, float]:
        return self.saves[-1] if self.saves else {}

    def _write(self, state: dict, path: Path, save_best: bool, rec: Dict[str, float]) -> None:
        """Write and commit one checkpoint (rank 0, on the writer thread),
        then copy model_best; its time goes to `rec`."""
        t0 = time.perf_counter()
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save(state, tmp)
        os.replace(tmp, path)
        if save_best:
            best = self.save_dir / "model_best.pth"
            shutil.copyfile(path, best.with_suffix(".tmp"))
            os.replace(best.with_suffix(".tmp"), best)
        rec["write_s"] = time.perf_counter() - t0
        logger.info("Saving checkpoint: %s ... (written in %.3f s)", path, rec["write_s"])
        if save_best:
            logger.info("Saving current best: model_best.pth ...")

    def _write_in_thread(self, *args) -> None:
        try:
            self._write(*args)
        except Exception as exc:  # re-raised by wait() on the training thread
            self._writer_exc = exc

    def save(self, model: torch.nn.Module, optimizer, epoch: int, monitor_best: float,
             save_best: bool = False) -> Path:
        t0 = time.perf_counter()
        self.wait()
        rec: Dict[str, float] = {}
        self.saves.append(rec)
        path = self.save_dir / f"checkpoint-epoch{epoch}.pth"
        sharded = any(isinstance(p, tp.DTensor) for p in model.parameters())
        if sharded:  # a collective: every rank takes part
            weights = tp.full_state_dict(model)
        else:
            weights = _host_copy(model.state_dict())
        opt_state = _optimizer_state(model, optimizer, sharded)
        if is_main_process():
            state = {
                "arch": self.arch,
                "epoch": epoch,
                "state_dict": weights,
                "optimizer": opt_state,
                "monitor_best": float(monitor_best),
                "config": self.config,
            }
            self._writer = threading.Thread(
                target=self._write_in_thread, args=(state, path, save_best, rec),
                name=f"checkpoint-epoch{epoch}", daemon=True)
            self._writer.start()
        self._pending = True
        sync_processes()
        if not self.async_save:
            self.wait()
        rec["stall_s"] = time.perf_counter() - t0
        return path

    def wait(self) -> None:
        """Join the write in flight, if any, and re-raise its exception.
        After a save every rank meets a barrier here, so the file rank 0
        committed is there for all of them."""
        writer, self._writer = self._writer, None
        if writer is not None:
            writer.join()
        if self._pending:
            self._pending = False
            sync_processes()
        exc, self._writer_exc = self._writer_exc, None
        if exc is not None:
            raise exc

    def latest(self, save_root, exper_name: str) -> Optional[Path]:
        """`find_latest_checkpoint` after the write in flight is committed."""
        self.wait()
        return find_latest_checkpoint(save_root, exper_name)

    def restore(self, path, model: torch.nn.Module, optimizer=None) -> Dict[str, Any]:
        """Load weights (strict) and, when given, the optimizer state into
        place; returns the checkpoint's metadata (epoch, monitor_best, ...)."""
        self.wait()
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
