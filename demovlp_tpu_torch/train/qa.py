"""Video-QA trainer (counterpart of demovlp_tpu/train/qa.py): cross-entropy
on the classifier's logits with a running accuracy; train text is trimmed
to `trainer.text_buckets` when set (QA max-pools over every position, pads
included, so trimming moves the loss as it does in the JAX package). Eval
takes the argmax of every val sample's logits (serve.predict_qa) and scores
them with `evaluate_qa`'s per-answer-type breakdown. Each train loss goes
to the writer one step late, as in the retrieval trainer. Across
processes the predictions are gathered in dataset order (JAX
qa.py:170-200) and the running accuracy counts the global batch.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from demovlp_tpu_torch.parallel.mesh import data_coords
from demovlp_tpu_torch.serve import predict_qa
from demovlp_tpu_torch.train.async_metrics import DeferredMetrics
from demovlp_tpu_torch.train.base_trainer import BaseTrainer
from demovlp_tpu_torch.train.steps import (batch_to_device, make_qa_eval_step,
                                           make_qa_train_step, parse_text_buckets,
                                           prepare_batch)


class QATrainer(BaseTrainer):
    """`fence_steps` and `step_times` / `step_losses` as in RetrievalTrainer."""

    def __init__(self, model, loss, metrics, optimizer, config, save_dir, device,
                 data_loader: List, valid_data_loader: Optional[List] = None,
                 tokenizer=None, max_samples_per_epoch: int = 50000,
                 transfer_dtype: Optional[torch.dtype] = None, fence_steps: bool = False,
                 **kwargs):
        super().__init__(model, loss, metrics, optimizer, config, save_dir, **kwargs)
        self.device = torch.device(device)
        self.data_loader = data_loader
        self.valid_data_loader = valid_data_loader or []
        self.do_validation = bool(self.valid_data_loader)
        self.tokenizer = tokenizer
        self.max_samples_per_epoch = max_samples_per_epoch
        self.len_epoch = min(len(dl) for dl in data_loader)
        self.total_batch_sum = sum(dl.batch_size for dl in data_loader)
        self.log_step = max(1, int(np.sqrt(data_loader[0].batch_size)))
        self.transfer_dtype = transfer_dtype
        self.fence_steps = fence_steps
        self.step_times: List[float] = []
        self.step_losses: List[float] = []
        self.step_text_lens: List[int] = []
        self.text_buckets = parse_text_buckets(config["trainer"])
        self.valid_label2ans = [dl.dataset.label2ans for dl in self.valid_data_loader]
        self.valid_qid2data = [dl.dataset.qid2data for dl in self.valid_data_loader]
        self._train_step = make_qa_train_step(model, loss, optimizer, mesh=self.mesh)
        self._eval_step = make_qa_eval_step(model)

    def _train_epoch(self, epoch: int) -> Dict[str, Any]:
        lr = self.current_lr(epoch)
        total_loss = [0.0] * len(self.data_loader)
        pos_cnt, tot_cnt, n_steps = 0.0, 0, 0
        for dl in self.data_loader:
            dl.set_epoch(epoch)

        def consume(m, dl_idx, batch_idx, step_no, n_text):
            nonlocal pos_cnt, tot_cnt
            loss_v = float(m["loss"])
            self.step_losses.append(loss_v)
            pos_cnt += float(m["correct"])
            tot_cnt += n_text
            total_loss[dl_idx] += loss_v
            if batch_idx % self.log_step == 0 and self.is_main:
                print(f"loss:{loss_v}, acc: {pos_cnt / max(1, tot_cnt)}, "
                      f"postive/all : {pos_cnt}/{tot_cnt}", flush=True)
            if self.writer is not None:
                self.writer.set_step(step_no, "train")
                self.writer.log_scalar(f"loss_train_{dl_idx}", loss_v)

        step_no = self.optimizer.step_count  # as in RetrievalTrainer
        deferred = DeferredMetrics(consume)
        for batch_idx, data_li in enumerate(zip(*self.data_loader)):
            if (batch_idx + 1) * self.total_batch_sum > self.max_samples_per_epoch:
                break
            for dl_idx, data in enumerate(data_li):
                arrays = prepare_batch(data, self.tokenizer, text_buckets=self.text_buckets)
                self.step_text_lens.append(int(arrays["input_ids"].shape[1]))
                batch = batch_to_device(arrays, self.device, self.transfer_dtype)
                t0 = time.perf_counter()
                m = self._train_step(batch, lr)
                if self.fence_steps:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    self.step_times.append(time.perf_counter() - t0)
                step_no += 1
                deferred.push(m, dl_idx, batch_idx, step_no,
                              len(data["text"]) * data_coords(self.mesh)[1])
                n_steps += 1
            if batch_idx == self.len_epoch:
                break
        deferred.flush()
        denom = max(1, n_steps // max(1, len(self.data_loader)))
        log = {f"loss_{i}": total_loss[i] / denom for i in range(len(self.data_loader))}
        log["train_acc"] = pos_cnt / max(1, tot_cnt)
        if self.do_validation:
            log.update(self._valid_epoch(epoch))
        return log

    def _valid_epoch(self, epoch: int) -> Dict[str, Any]:
        nested: Dict[int, Dict[str, Any]] = {}
        res: Dict[str, Any] = {}
        for dl_idx, dl in enumerate(self.valid_data_loader):
            qid2data = self.valid_qid2data[dl_idx]
            results = [dict(r, data=qid2data[r["question_id"]]) for r in predict_qa(
                self._eval_step, dl, self.tokenizer, self.device,
                transfer_dtype=self.transfer_dtype, mesh=self.mesh)]
            if self.is_main:
                print(f"Get {len(results)} results.", flush=True)
            dl_metrics: Dict[str, Any] = {}
            for metric in self.metrics:
                dl_metrics[metric.__name__] = r = metric(results, self.valid_label2ans[dl_idx],
                                                         qid2data)
                if self.is_main:
                    print(r, flush=True)
            nested[dl_idx] = dl_metrics
            res[f"val_loss_{dl_idx}"] = 0.0
        res["nested_val_metrics"] = nested
        return res
