"""Multiple-choice trainer, eval only (counterpart of demovlp_tpu/train/mc.py):
each item is one video and its option texts; the video is repeated over
the options, each option scored by global + local similarity, and the
argmax over the options is the prediction. `trainer.mc_eval_batch` items
(default 8) go through the towers in one call (`make_mc_eval_step_batched`);
1 takes the reference-shaped batch-1 path (`make_mc_eval_step`). Across
processes each data rank scores its loader shard (its wrapped duplicates
scored, so every rank runs the same calls, but not recorded) and
`merge_mc_predictions` gathers the {mc_id: prediction} maps over the
dataset's id positions (JAX mc.py:31-60, :220).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from demovlp_tpu_torch.parallel.mesh import data_allgather
from demovlp_tpu_torch.train.base_trainer import BaseTrainer
from demovlp_tpu_torch.train.steps import (batch_to_device, make_mc_eval_step,
                                           make_mc_eval_step_batched, prepare_batch)

_MODEL_KEYS = ("input_ids", "attention_mask", "object", "object_mask")


def merge_mc_predictions(preds: Dict[Any, int], metadata_ids: List[Any],
                         allgather: Optional[Callable] = None) -> Dict[Any, int]:
    """Merge the processes' {mc_id: prediction} maps, every id checked
    against the dataset's id sequence. The ids travel as their positions in
    that sequence (identical on every process), padded with -1 to the
    largest count. Without `allgather` (one process) the map is returned
    in the order it was filled."""
    known = set(metadata_ids)
    unknown = [k for k in preds if k not in known]
    if unknown:
        raise KeyError(f"mc ids not in the dataset: {unknown[:5]}")
    if allgather is None:
        return {k: int(p) for k, p in preds.items()}
    id2idx = {mc_id: i for i, mc_id in enumerate(metadata_ids)}
    idx = np.asarray([id2idx[k] for k in preds], np.int64)
    pred = np.asarray(list(preds.values()), np.int64)
    cap = int(np.max(allgather(np.asarray([idx.size], np.int64))))
    fill = np.full(cap - idx.size, -1, np.int64)
    all_idx = allgather(np.concatenate([idx, fill]))
    all_pred = allgather(np.concatenate([pred, fill]))
    return {metadata_ids[int(i)]: int(p) for i, p in zip(all_idx, all_pred) if i >= 0}


class MCTrainer(BaseTrainer):
    def __init__(self, model, loss, metrics, optimizer, config, save_dir, device,
                 data_loader: List, valid_data_loader: Optional[List] = None,
                 tokenizer=None, max_samples_per_epoch: int = 0,
                 transfer_dtype: Optional[torch.dtype] = None, fence_steps: bool = False,
                 **kwargs):
        # max_samples_per_epoch and fence_steps: the train CLIs' common
        # arguments, which an eval-only trainer does not use
        super().__init__(model, loss, metrics, optimizer, config, save_dir, **kwargs)
        self.device = torch.device(device)
        self.data_loader = data_loader
        self.valid_data_loader = valid_data_loader or []
        self.tokenizer = tokenizer
        self.transfer_dtype = transfer_dtype
        self.valid_gt_id2answer = [dl.dataset.id2answer for dl in self.valid_data_loader]
        self.mc_eval_batch = int(config.get("trainer", {}).get("mc_eval_batch", 8))
        if self.mc_eval_batch > 1:
            self._eval_step = make_mc_eval_step_batched(model, loss)
        else:
            self._eval_step = make_mc_eval_step(model, loss)

    def _train_epoch(self, epoch: int):
        return None  # eval-only task

    def _items(self, dl):
        """(mc_id, option arrays with the video repeated, whether to record
        it: not a shard's wrapped duplicate) per loader item."""
        for data in dl:
            arrays = prepare_batch(data, self.tokenizer)
            arrays.pop("label", None)
            flags = arrays.pop("sample_valid", None)
            n_opt = arrays["input_ids"].shape[0]
            arrays["object"] = np.repeat(data["object"], n_opt, axis=0)
            arrays["object_mask"] = np.repeat(data["object_mask"], n_opt, axis=0)
            yield data["mc_id"][0], arrays, flags is None or bool(flags[0])

    def predict(self, dl) -> Dict[Any, int]:
        """{mc_id: argmax option} over an eval loader (batch 1: one item a
        loader batch)."""
        preds: Dict[Any, int] = {}
        if self.mc_eval_batch <= 1:
            for mc_id, arrays, record in self._items(dl):
                scores = self._eval_step(batch_to_device(arrays, self.device,
                                                         self.transfer_dtype))
                if record:
                    preds[mc_id] = int(torch.argmax(scores))
            return preds
        group: List[Dict[str, np.ndarray]] = []
        ids: List[Any] = []

        def flush():
            n_real = len(group)
            group.extend([group[0]] * (self.mc_eval_batch - n_real))  # one shape a call
            batch = {k: np.stack([g[k] for g in group]) for k in _MODEL_KEYS}
            scores = self._eval_step(batch_to_device(batch, self.device, self.transfer_dtype))
            for mc_id, row in zip(ids, torch.argmax(scores[:n_real], dim=-1).tolist()):
                if mc_id is not None:
                    preds[mc_id] = int(row)
            group.clear()
            ids.clear()

        for mc_id, arrays, record in self._items(dl):
            group.append(arrays)
            ids.append(mc_id if record else None)
            if len(group) == self.mc_eval_batch:
                flush()
        if group:
            flush()
        return preds

    def _valid_epoch(self, epoch: int) -> Dict[str, Any]:
        nested: Dict[int, Dict[str, Any]] = {}
        for dl_idx, dl in enumerate(self.valid_data_loader):
            gt = self.valid_gt_id2answer[dl_idx]
            preds = merge_mc_predictions(self.predict(dl), list(gt),
                                         data_allgather(self.mesh))
            dl_metrics: Dict[str, Any] = {}
            for metric in self.metrics:
                dl_metrics[metric.__name__] = r = metric(preds, gt)
                if self.is_main:
                    print(r, flush=True)
            nested[dl_idx] = dl_metrics
        res: Dict[str, Any] = {f"val_loss_{i}": 0.0 for i in range(len(self.valid_data_loader))}
        res["nested_val_metrics"] = nested
        return res

    def train(self) -> Dict[str, Any]:
        """Eval-only protocol: one validation pass (the configs set epochs 0)."""
        return self._flatten_log(0, self._valid_epoch(0))
