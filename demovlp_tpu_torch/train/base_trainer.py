"""Epoch-loop base trainer (counterpart of demovlp_tpu/train/base_trainer.py).

Reference behaviour kept:
  * optional validation before training (`init_val`);
  * epochs are 1-indexed: range(start_epoch, epochs + 1);
  * nested val metrics become flat `val_{dl}_{metric}_{sub}` log keys;
  * a "min val_loss_0"-style monitor, or "off"; a missing key disables
    monitoring with a warning;
  * a checkpoint is saved EVERY epoch (`save_period` is accepted and, as in
    the reference, gates nothing), and copied to model_best on improvement;
  * `early_stop` is read and, as in the reference, never breaks the loop;
  * resume restores weights, optimizer state, epoch and monitor_best.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import numpy as np

from demovlp_tpu_torch.train.checkpoint import CheckpointManager
from demovlp_tpu_torch.train.optim import step_decay_lr


class BaseTrainer:
    def __init__(self, model, loss, metrics: List, optimizer, config: Dict[str, Any],
                 save_dir, schedule=(30, 40), learning_rate1: float = 2e-4,
                 lr_mode: str = "reference", rng_seed: int = 0):
        self.model = model
        self.loss = loss
        self.metrics = metrics
        self.optimizer = optimizer
        self.config = config
        self.schedule = list(schedule)
        self.learning_rate1 = learning_rate1
        self.lr_mode = lr_mode
        self.rng_seed = rng_seed  # the run's --seed (host-side draws, e.g. MLM masks)
        self.logger = logging.getLogger("trainer")

        cfg_trainer = config["trainer"]
        self.epochs = cfg_trainer["epochs"]
        self.monitor = cfg_trainer.get("monitor", "off")
        self.init_val = cfg_trainer.get("init_val", True)
        self.base_lr = float(config["optimizer"]["args"].get("lr", 1e-5))
        if self.monitor == "off":
            self.mnt_mode, self.mnt_best = "off", 0
        else:
            self.mnt_mode, self.mnt_metric = self.monitor.split()
            if self.mnt_mode not in ("min", "max"):
                raise ValueError(f"monitor mode {self.mnt_mode!r}: expected min or max")
            self.mnt_best = np.inf if self.mnt_mode == "min" else -np.inf
        self.start_epoch = 1
        self.checkpoint = CheckpointManager(save_dir, arch=type(model).__name__, config=config)

    def _train_epoch(self, epoch: int) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def _valid_epoch(self, epoch: int) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def current_lr(self, epoch: int) -> float:
        return step_decay_lr(epoch, self.base_lr, self.learning_rate1, self.schedule,
                             self.lr_mode)

    def resume(self, path) -> None:
        meta = self.checkpoint.restore(path, self.model, self.optimizer)
        self.start_epoch = int(meta.get("epoch", 0)) + 1
        if "monitor_best" in meta:
            self.mnt_best = meta["monitor_best"]
        print(f"[train] resumed from {path} at epoch {self.start_epoch}", flush=True)

    @staticmethod
    def _flatten_log(epoch: int, result: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        log: Dict[str, Any] = {"epoch": epoch}
        for key, value in (result or {}).items():
            if key == "nested_val_metrics":
                for dl_key, dl_val in value.items():
                    for m_key, m_val in dl_val.items():
                        if isinstance(m_val, dict):
                            for sub_key, sub_val in m_val.items():
                                log[f"val_{dl_key}_{m_key}_{sub_key}"] = sub_val
                        else:
                            log[f"val_{dl_key}_{m_key}"] = m_val
            else:
                log[key] = value
        return log

    def train(self) -> Dict[str, Any]:
        if self.init_val:
            self._valid_epoch(-1)
        final_log: Dict[str, Any] = {}
        for epoch in range(self.start_epoch, self.epochs + 1):
            log = self._flatten_log(epoch, self._train_epoch(epoch))
            for key, value in log.items():
                print(f"    {key:15s}: {value}", flush=True)
            best = False
            if self.mnt_mode != "off":
                if self.mnt_metric not in log:
                    self.logger.warning("Metric '%s' not found; monitoring disabled.",
                                        self.mnt_metric)
                    self.mnt_mode = "off"
                elif (self.mnt_mode == "min" and log[self.mnt_metric] <= self.mnt_best) or (
                        self.mnt_mode == "max" and log[self.mnt_metric] >= self.mnt_best):
                    self.mnt_best = log[self.mnt_metric]
                    best = True
            self.checkpoint.save(self.model, self.optimizer, epoch, self.mnt_best,
                                 save_best=best)
            final_log = log
        return final_log
