"""Batch preparation and the retrieval train and eval steps (counterpart of
demovlp_tpu/train/steps.py: `prepare_batch`, `pad_batch`,
`_retrieval_losses`, `make_retrieval_train_step`,
`make_retrieval_eval_step`).

Text buckets are off: every batch is tokenized to the fixed length 100, as
the reference does. The MLM objective and `cast_tower_weights` (numerically
a no-op) are not ported.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from demovlp_tpu_torch.device import to_device
from demovlp_tpu_torch.ops.masking import additive_mask
from demovlp_tpu_torch.ops.similarity import sim_matrix


def prepare_batch(batch: Dict[str, Any], tokenizer, max_text_len: int = 100):
    """Tokenize the text and assemble the model's numpy array batch."""
    enc = tokenizer(batch["text"], max_length=max_text_len)
    return {
        "input_ids": enc["input_ids"],
        "attention_mask": enc["attention_mask"],
        "object": batch["object"],
        "object_mask": batch["object_mask"],
    }


def pad_batch(arrays: Dict[str, np.ndarray], target: int) -> Tuple[Dict, int]:
    """Pad the batch axis to `target` rows by repeating row 0; returns
    (padded, n_valid)."""
    n = next(iter(arrays.values())).shape[0]
    if n == target:
        return arrays, n
    if n > target:
        raise ValueError(f"batch of {n} rows exceeds the target {target}")
    out = {k: np.concatenate([v, np.repeat(v[:1], target - n, axis=0)], axis=0)
           for k, v in arrays.items()}
    return out, n


def batch_to_device(arrays: Dict[str, np.ndarray], device: torch.device,
                    transfer_dtype: torch.dtype | None = None) -> Dict[str, torch.Tensor]:
    """The model's batch on `device`. `transfer_dtype` (bf16 for a bf16
    model) casts the region tensor on the host before upload; the tower's
    first op casts to its compute dtype anyway, so this is bit-identical."""
    out = {
        "input_ids": to_device(arrays["input_ids"].astype(np.int64), device),
        "attention_mask": to_device(arrays["attention_mask"].astype(np.int64), device),
        "object": to_device(arrays["object"], device, transfer_dtype),
        "object_mask": to_device(arrays["object_mask"], device),
    }
    if "valid" in arrays:
        out["valid"] = to_device(arrays["valid"], device)
    return out


def retrieval_losses(loss_obj, outputs, batch, valid=None):
    """(total, global, local). The towers may run in bf16; the global sims
    and both local embeddings enter the losses in f32."""
    global_sim = sim_matrix(outputs["global_text_embeddings"].float(),
                            outputs["global_object_embeddings"].float())
    text_mask = additive_mask(batch["attention_mask"][:, 1:])
    text_len = torch.sum(batch["attention_mask"], dim=1)
    return loss_obj(
        global_sim,
        outputs["local_object_embeddings"].float(),
        outputs["local_text_embeddings"].float(),
        outputs["object_mask"],
        text_len,
        text_mask,
        valid=valid,
    )


def make_retrieval_train_step(model: torch.nn.Module, loss_obj, optimizer,
                              deterministic: bool = False) -> Callable:
    """step(batch, lr) -> metrics (device scalars): forward (dropout on
    unless `deterministic`), losses, backward, one AdamW update at `lr`.
    The gradients stay in `p.grad` until the next step."""

    def step(batch: Dict[str, torch.Tensor], lr: float) -> Dict[str, torch.Tensor]:
        model.train(not deterministic)
        optimizer.set_lr(lr)
        optimizer.zero_grad(set_to_none=True)
        total, g, l = retrieval_losses(loss_obj, model(batch), batch)
        total.backward()
        optimizer.step()
        return {"loss": total.detach(), "global_loss": g.detach(), "local_loss": l.detach()}

    return step


def make_retrieval_eval_step(model: torch.nn.Module, loss_obj) -> Callable:
    """step(batch) -> (embedding dict, (total, global, local)). An optional
    batch["valid"] (B,) 0/1 mask excludes pad rows from the loss."""

    @torch.inference_mode()
    def step(batch: Dict[str, torch.Tensor]):
        batch = dict(batch)
        valid = batch.pop("valid", None)
        model.eval()
        out = dict(model(batch))
        losses = retrieval_losses(loss_obj, out, batch, valid)
        out["text_mask_add"] = additive_mask(batch["attention_mask"][:, 1:])
        out["text_length"] = torch.sum(batch["attention_mask"], dim=1).to(torch.int32)
        return out, losses

    return step
