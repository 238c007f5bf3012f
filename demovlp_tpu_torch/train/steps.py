"""Batch preparation and the train and eval steps (counterpart of
demovlp_tpu/train/steps.py: `prepare_batch`, `parse_text_buckets`,
`pad_batch`, `_retrieval_losses`, `mlm_loss_fn`,
`make_retrieval_train_step`, `make_retrieval_eval_step`,
`make_qa_train_step`, `make_qa_eval_step`, `make_mc_eval_step_batched`,
`make_mc_eval_step`).

Every batch is tokenized to the fixed length 100, as the reference does;
with `text_buckets` (train batches only) it is then trimmed to the
smallest bucket that holds its longest text. One process, so the bucket
needs no agreement across processes. `cast_tower_weights` (numerically a
no-op) is not ported.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from demovlp_tpu_torch.device import to_device
from demovlp_tpu_torch.ops.masking import additive_mask
from demovlp_tpu_torch.ops.similarity import sim_matrix


def prepare_batch(batch: Dict[str, Any], tokenizer, max_text_len: int = 100,
                  text_buckets=None):
    """Tokenize the text and assemble the model's numpy array batch. A
    multiple-choice item's option texts are flattened in order; a batch's
    labels are carried.

    text_buckets: sorted lengths (e.g. [32, 48, 64]). The (B, max_text_len)
    encoding is trimmed to the smallest bucket b with longest <= b < L, and
    kept at L where none fits, so no token is ever trimmed. Exact for what
    reads only unmasked text; the local loss (its mean over every query
    position) and QA's max-pool read the pads too, as in the JAX package
    (PARITY.md #14)."""
    text = batch["text"]
    if text and isinstance(text[0], (list, tuple)):
        text = [t for opts in text for t in opts]
    enc = tokenizer(text, max_length=max_text_len)
    if text_buckets:
        longest = int(enc["attention_mask"].sum(axis=1).max())
        length = enc["input_ids"].shape[1]
        target = min((b for b in text_buckets if longest <= b < length), default=length)
        if target < length:
            enc = {"input_ids": enc["input_ids"][:, :target],
                   "attention_mask": enc["attention_mask"][:, :target]}
    arrays = {
        "input_ids": enc["input_ids"],
        "attention_mask": enc["attention_mask"],
        "object": batch["object"],
        "object_mask": batch["object_mask"],
    }
    if "label" in batch:
        arrays["label"] = batch["label"]
    return arrays


def parse_text_buckets(trainer_cfg: Dict[str, Any]):
    """`trainer.text_buckets` -> a sorted list of ints, or None where it is
    absent or empty."""
    return sorted(int(b) for b in (trainer_cfg.get("text_buckets") or [])) or None


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
    if "label" in arrays:
        out["label"] = to_device(arrays["label"].astype(np.int64), device)
    if "mlm_labels" in arrays:
        out["mlm_labels"] = to_device(arrays["mlm_labels"].astype(np.int64), device)
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


def mlm_loss_fn(logits, labels, ignore_index: int = -100):
    """Masked-LM cross-entropy (f32) averaged over the positions whose label
    is not `ignore_index`; 0 where there are none."""
    logits = logits.float()
    valid = (labels != ignore_index).float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
    return torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1.0)


def make_retrieval_train_step(model: torch.nn.Module, loss_obj, optimizer,
                              deterministic: bool = False,
                              mlm_weight: float = 0.0) -> Callable:
    """step(batch, lr) -> metrics (device scalars): forward (dropout on
    unless `deterministic`), losses, backward, one AdamW update at `lr`.
    With `mlm_weight` the model's MLM head runs on the masked text and
    mlm_weight * mlm_loss_fn(logits, batch["mlm_labels"]) joins the total;
    `mlm_loss` is 0 otherwise. The gradients stay in `p.grad` until the
    next step."""

    def step(batch: Dict[str, torch.Tensor], lr: float) -> Dict[str, torch.Tensor]:
        model.train(not deterministic)
        optimizer.set_lr(lr)
        optimizer.zero_grad(set_to_none=True)
        out = model(batch, mlm=True) if mlm_weight else model(batch)
        total, g, l = retrieval_losses(loss_obj, out, batch)
        if mlm_weight:
            mlm = mlm_loss_fn(out["mlm_logits"], batch["mlm_labels"])
            total = total + mlm_weight * mlm
        else:
            mlm = torch.zeros((), dtype=torch.float32, device=total.device)
        total.backward()
        optimizer.step()
        return {"loss": total.detach(), "global_loss": g.detach(), "local_loss": l.detach(),
                "mlm_loss": mlm.detach()}

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


def make_qa_train_step(model: torch.nn.Module, loss_obj, optimizer,
                       deterministic: bool = False) -> Callable:
    """step(batch, lr) -> {"loss", "correct"} (device scalars): forward
    (dropout on unless `deterministic`), cross-entropy on the logits,
    backward, one AdamW update; `correct` counts argmax hits."""

    def step(batch: Dict[str, torch.Tensor], lr: float) -> Dict[str, torch.Tensor]:
        model.train(not deterministic)
        optimizer.set_lr(lr)
        optimizer.zero_grad(set_to_none=True)
        logits = model(batch)["logits"]
        loss = loss_obj(logits, batch["label"])
        loss.backward()
        optimizer.step()
        correct = torch.sum((torch.argmax(logits, dim=-1) == batch["label"]).float())
        return {"loss": loss.detach(), "correct": correct.detach()}

    return step


def make_qa_eval_step(model: torch.nn.Module) -> Callable:
    """step(batch) -> logits (B, num_label)."""

    @torch.inference_mode()
    def step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        model.eval()
        return model(batch)["logits"]

    return step


def _mc_local_row0(loss_obj, l_o0, o_mask0, l_t, t_mask, n_opt: int) -> torch.Tensor:
    """(B, n_opt) local sims of each item's first video row against its own
    options. l_o0 (B, R, D) and o_mask0 (B, R) are the items' first rows,
    l_t (B * n_opt, W, D) and t_mask every option; one call scores every
    video row against every option, and each item keeps its own block."""
    b = l_o0.shape[0]
    sims = loss_obj.local_loss.get_sim(l_o0, l_t, o_mask0, None, t_mask)  # (B, B * n_opt)
    idx = torch.arange(b, device=sims.device)
    return sims.reshape(b, b, n_opt)[idx, idx]


def make_mc_eval_step_batched(model: torch.nn.Module, loss_obj) -> Callable:
    """step(batch) -> (B, n_options) scores for B multiple-choice items a
    call; batch arrays are (B, n_options, ...), each item's video repeated
    over its options. Per item the score of option p is the reference's
    global(text 0, video p) + local(video 0, text p) (row 0 of the item's
    (n_opt, n_opt) matrix, orientation quirk kept), identical item by item
    to `make_mc_eval_step`."""

    @torch.inference_mode()
    def step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        b, n_opt = batch["input_ids"].shape[:2]
        flat = {k: v.reshape((b * n_opt,) + v.shape[2:]) for k, v in batch.items()}
        model.eval()
        out = model(flat)

        def by_item(x):
            return x.reshape((b, n_opt) + x.shape[1:])

        eps = 1e-8
        g_t = by_item(out["global_text_embeddings"]).float()
        g_o = by_item(out["global_object_embeddings"]).float()
        g_t = g_t / torch.clamp(torch.linalg.norm(g_t, dim=-1, keepdim=True), min=eps)
        g_o = g_o / torch.clamp(torch.linalg.norm(g_o, dim=-1, keepdim=True), min=eps)
        gsim = torch.einsum("bd,bpd->bp", g_t[:, 0], g_o)
        text_mask = additive_mask(flat["attention_mask"][:, 1:])
        lsim = _mc_local_row0(loss_obj, by_item(out["local_object_embeddings"])[:, 0].float(),
                              by_item(out["object_mask"])[:, 0].float(),
                              out["local_text_embeddings"].float(), text_mask, n_opt)
        return gsim + lsim

    return step


def make_mc_eval_step(model: torch.nn.Module, loss_obj) -> Callable:
    """step(batch) -> (n_options,) scores of one item (batch of n_options
    rows: the video repeated, one option text a row), the batch-1 form."""

    @torch.inference_mode()
    def step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        model.eval()
        out = model(batch)
        gsim = sim_matrix(out["global_text_embeddings"].float(),
                          out["global_object_embeddings"].float())
        text_mask = additive_mask(batch["attention_mask"][:, 1:])
        lsim = _mc_local_row0(loss_obj, out["local_object_embeddings"][:1].float(),
                              out["object_mask"][:1].float(),
                              out["local_text_embeddings"].float(), text_mask,
                              batch["input_ids"].shape[0])
        return gsim[0] + lsim[0]

    return step
