"""Retrieval trainer (counterpart of demovlp_tpu/train/retrieval.py).

Train: zip over the train loaders, one batch from each per step, capped by
`max_samples_per_epoch`; tokenize (trimmed to `trainer.text_buckets` when
set; validation keeps the full length) -> with `mlm.weight` > 0 the text
masked 80/10/10 on the host by `default_rng(seed + 1)`, as the JAX trainer
draws it -> train step on the device -> the epoch's learning rate from the
step-decay schedule. Losses are read one step late
(train/async_metrics.py), so the host prepares the next batch while the
card runs the current step; each goes to the writer there, as
`train/loss_train_{dl}` at the optimizer's update count, with no read of
the card of its own.

Eval: embed every val batch, assemble the embeddings on the host, then the
global cosine sims plus the local sims through the f32 forward kernel
(serve.combined_sims), and the retrieval metrics. The reference's
orientation quirk is kept — global(text, video) + local(video, text) summed
elementwise — and MSCOCO-named configs take every 5th video row. The
visualizer (when configured) renders the rankings, and the writer takes
`loss_val_{dl}`. `eval.xattn_backend` (JAX's eval route, default "auto")
is checked against JAX `set_backend`'s values, and `eval.local_sim_segment`
(JAX's eval tiling of the local sims, default 64) is checked to be a
positive integer; the port's eval runs the kernel either way, chunked by
parallel/sharded_eval.py, which does that knob's job.

Across processes (JAX retrieval.py:288-312): each data rank embeds its
loader shard, drops the pad rows and wrapped duplicates, and the
embeddings and metadata are gathered once after the loop
(`host_allgather_ragged` / `_pylist`); the val loss is the global batch's
over its valid rows.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from demovlp_tpu_torch.data.mlm import mask_batch_text_tokens
from demovlp_tpu_torch.ops.xattn_kernel import check_backend
from demovlp_tpu_torch.parallel.mesh import (data_allgather, host_allgather_pylist,
                                             host_allgather_ragged)
from demovlp_tpu_torch.serve import EMBED_KEYS, OUT_KEYS, combined_sims
from demovlp_tpu_torch.train.async_metrics import DeferredMetrics
from demovlp_tpu_torch.train.base_trainer import BaseTrainer
from demovlp_tpu_torch.train.steps import (batch_to_device, make_retrieval_eval_step,
                                           make_retrieval_train_step, pad_batch,
                                           parse_text_buckets, prepare_batch)
from demovlp_tpu_torch.utils import profiling

def check_eval_keys(config: Dict[str, Any]) -> None:
    """`eval.xattn_backend` one of JAX `set_backend`'s values (default
    "auto") and `eval.local_sim_segment` a positive integer (default 64),
    as JAX retrieval.py:91-95 reads them; else ValueError naming the key."""
    ev = config.get("eval", {}) or {}
    check_backend("eval.xattn_backend", ev.get("xattn_backend", "auto"))
    segment = ev.get("local_sim_segment", 64)
    if isinstance(segment, bool) or not isinstance(segment, int) or segment < 1:
        raise ValueError(f"eval.local_sim_segment={segment!r}: expected a positive integer")


def verbose(epoch, metrics, mode, name="TEST"):
    msg = (f"[{mode}]{name:s} epoch {epoch}, R@1: {metrics['R1']:.1f}, "
           f"R@5: {metrics['R5']:.1f}, R@10 {metrics['R10']:.1f}, R@50 {metrics['R50']:.1f}"
           f"MedR: {metrics['MedR']:g}, MeanR: {metrics['MeanR']:.1f}")
    print(msg, flush=True)
    return msg


class RetrievalTrainer(BaseTrainer):
    """`fence_steps` synchronises the card after every train step and keeps
    each step's wall time in `step_times` (for measurement; it removes the
    host/card overlap). `step_losses` keeps every step's total loss,
    `step_text_lens` every train batch's text length after bucketing."""

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
        self.transfer_dtype = transfer_dtype  # see steps.batch_to_device
        self.fence_steps = fence_steps
        self.step_times: List[float] = []
        self.step_losses: List[float] = []
        self.step_text_lens: List[int] = []
        self.text_buckets = parse_text_buckets(config["trainer"])
        check_eval_keys(config)
        mlm = config.get("mlm", {}) or {}
        self.mlm_weight = float(mlm.get("weight", 0.0))
        self.mlm_prob = float(mlm.get("mask_prob", 0.15))
        self.mlm_mask_token = int(mlm.get("mask_token_id", 103))
        self.mlm_vocab = int(mlm.get("vocab_size", model.text_model.config.vocab_size))
        self._mlm_rng = np.random.default_rng(self.rng_seed + 1)
        self._train_step = make_retrieval_train_step(model, loss, optimizer,
                                                     mlm_weight=self.mlm_weight,
                                                     mesh=self.mesh, dropout_seed=self.rng_seed)
        self._eval_step = make_retrieval_eval_step(model, loss, mesh=self.mesh)

    def _train_epoch(self, epoch: int) -> Dict[str, Any]:
        lr = self.current_lr(epoch)
        total_loss = [0.0] * len(self.data_loader)
        n_steps = 0
        for dl in self.data_loader:
            dl.set_epoch(epoch)

        def consume(m, dl_idx, batch_idx, step_no):
            loss_v = float(m["loss"])
            self.step_losses.append(loss_v)
            if batch_idx % self.log_step == 0 and self.is_main:
                print(f"loss:{loss_v}, global_loss: {float(m['global_loss'])}, "
                      f"local_loss: {float(m['local_loss'])}", flush=True)
            total_loss[dl_idx] += loss_v
            if self.writer is not None:
                self.writer.set_step(step_no, "train")
                self.writer.log_scalar(f"loss_train_{dl_idx}", loss_v)

        # the global step on the host: the optimizer's update count (restored
        # on resume), advanced once a train step
        step_no = self.optimizer.step_count
        deferred = DeferredMetrics(consume)
        for batch_idx, data_li in enumerate(zip(*self.data_loader)):
            if (batch_idx + 1) * self.total_batch_sum > self.max_samples_per_epoch:
                break
            for dl_idx, data in enumerate(data_li):
                batch = batch_to_device(self.train_arrays(data), self.device,
                                        self.transfer_dtype)
                t0 = time.perf_counter()
                m = self._train_step(batch, lr)
                if self.fence_steps:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    self.step_times.append(time.perf_counter() - t0)
                step_no += 1
                deferred.push(m, dl_idx, batch_idx, step_no)
                n_steps += 1
            if batch_idx == self.len_epoch:
                break
        deferred.flush()
        denom = max(1, n_steps // max(1, len(self.data_loader)))
        log = {f"loss_{i}": total_loss[i] / denom for i in range(len(self.data_loader))}
        if self.do_validation:
            log.update(self._valid_epoch(epoch))
        return log

    def train_arrays(self, data) -> Dict[str, np.ndarray]:
        """A train batch's arrays: tokenized, trimmed to its bucket and,
        with the MLM objective, masked (drawing from the trainer's MLM
        generator). Span `train.prepare`."""
        with profiling.span("train.prepare"):
            arrays = prepare_batch(data, self.tokenizer, text_buckets=self.text_buckets)
            arrays.pop("label", None)
            self.step_text_lens.append(int(arrays["input_ids"].shape[1]))
            if self.mlm_weight:
                arrays["input_ids"], arrays["mlm_labels"] = mask_batch_text_tokens(
                    arrays["input_ids"], arrays["attention_mask"],
                    mask_token_id=self.mlm_mask_token, vocab_size=self.mlm_vocab,
                    rng=self._mlm_rng, mlm_probability=self.mlm_prob)
        return arrays

    def embed(self, dl, metas: Optional[List[Dict[str, Any]]] = None):
        """Every sample of an eval loader once: (host embedding dict, mean
        batch loss). Each sample's meta dict is appended to `metas` when a
        list is given. Across processes both are gathered in dataset order."""
        arrs: Dict[str, List[np.ndarray]] = {k: [] for k in EMBED_KEYS}
        total_val_loss, n_batches = 0.0, 0
        local_metas: List[Dict[str, Any]] = []
        for data in dl:
            arrays = prepare_batch(data, self.tokenizer)
            flags = arrays.pop("sample_valid", None)
            arrays, n_valid = pad_batch(arrays, dl.batch_size)
            keep = np.arange(dl.batch_size) < n_valid
            if flags is not None:
                keep[:n_valid] &= flags.astype(bool)
            local_metas.extend(m for m, k in zip(data["meta"], keep) if k)
            arrays["valid"] = keep.astype(np.float32)
            out, (loss, _, _) = self._eval_step(
                batch_to_device(arrays, self.device, self.transfer_dtype))
            total_val_loss += float(loss)
            n_batches += 1
            for k in EMBED_KEYS:
                if OUT_KEYS[k] not in out:  # a global-only model's local keys
                    continue
                v = out[OUT_KEYS[k]]
                arrs[k].append((v.float() if v.is_floating_point() else v).cpu().numpy()[keep])
        cat = {k: np.concatenate(v, axis=0) for k, v in arrs.items() if v}
        if self.mesh is not None:
            gather = data_allgather(self.mesh)
            cat = {k: host_allgather_ragged(v, gather) for k, v in cat.items()}
            local_metas = host_allgather_pylist(local_metas, gather)
        if metas is not None:
            metas.extend(local_metas)
        return cat, total_val_loss / max(1, n_batches)

    def _valid_epoch(self, epoch: int) -> Dict[str, Any]:
        res: Dict[str, Any] = {}
        nested: Dict[int, Dict[str, Any]] = {}
        loss_args = self.config["loss"].get("args", {})
        # a global-only loss (NormSoftmaxLoss) scores eval by the global sims alone
        local = getattr(self.loss, "local_loss", None)
        knobs = ({"use_local": False} if local is None else
                 {"use_local": bool(loss_args.get("use_local", True)),
                  "lambda_softmax": local.lambda_softmax, "focal_type": local.focal_type})
        for dl_idx, dl in enumerate(self.valid_data_loader):
            metas: List[Dict[str, Any]] = []
            cat, res[f"val_loss_{dl_idx}"] = self.embed(dl, metas)
            sims = combined_sims(
                cat, self.device, **knobs,
                mscoco_dedup=str(self.config["name"]).startswith("MSCOCO"), mesh=self.mesh)
            dl_metrics = {}
            for metric in self.metrics:
                dl_metrics[metric.__name__] = r = metric(sims)
                if self.is_main:
                    verbose(epoch, r, name=dl.dataset_name, mode=metric.__name__)
            nested[dl_idx] = dl_metrics
            if self.visualizer is not None:
                meta = {"paths": [m.get("paths", "") for m in metas],
                        "raw_captions": [m.get("raw_captions", "") for m in metas]}
                self.visualizer.visualize_ranking(sims, epoch, meta, dl_metrics)
            if self.writer is not None:
                self.writer.log_scalar(f"loss_val_{dl_idx}", res[f"val_loss_{dl_idx}"])
        res["nested_val_metrics"] = nested
        return res
