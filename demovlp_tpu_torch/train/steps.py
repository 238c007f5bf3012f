"""Batch preparation and the train and eval steps (counterpart of
demovlp_tpu/train/steps.py: `prepare_batch`, `parse_text_buckets`,
`pad_batch`, `_retrieval_losses`, `mlm_loss_fn`,
`make_retrieval_train_step`, `make_retrieval_eval_step`,
`make_qa_train_step`, `make_qa_eval_step`, `make_mc_eval_step_batched`,
`make_mc_eval_step`).

Every batch is tokenized to the fixed length 100, as the reference does;
with `text_buckets` (train batches only) it is then trimmed to the
smallest bucket that holds its longest text, the largest such bucket over
the processes (JAX steps.py:72-79). `cast_tower_weights` (numerically a
no-op) is not ported.

With a mesh (parallel/mesh.py) whose data axis has more than one rank,
each rank runs the towers on its own rows, and the embeddings the loss
reads are all-gathered (`gather_rows`, whose backward keeps this rank's
slice), so every rank computes the global loss over the concatenated
batch, as JAX's replicated assembly does. The gradients are then summed
over the data axis: each rank's gradient holds only its rows' share of
the one global loss, so the sum is the one-process gradient, and
`max_grad_norm` clips the summed gradient. The MLM loss is normalised by
the global count of masked tokens and the QA cross-entropy is a mean over
the global batch. Without a mesh nothing is gathered or reduced.

Dropout (JAX steps.py:199,268 fold the step into the dropout key): a train
step that is not `deterministic` runs its forward with torch's default
generators (the CPU's and the step's device's) seeded by (`dropout_seed`,
the optimizer's update count before the step, the data rank), so the
model's nn.Dropout layers draw keyed masks, and restores their states
after. The count is restored with the optimizer state, so a run
resumed from a checkpoint draws the masks the uninterrupted run drew, and
data ranks draw different masks; the ranks of one model group share a data
rank and so their masks. A remat recompute (torch.utils.checkpoint) restores
the forward's generator state and so redraws the same masks. The stream is
not JAX's (the PRNGs differ).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from demovlp_tpu_torch.device import to_device
from demovlp_tpu_torch.ops.masking import additive_mask
from demovlp_tpu_torch.ops.similarity import sim_matrix
from demovlp_tpu_torch.parallel.mesh import (all_reduce_max_int, all_reduce_sum, data_coords,
                                             data_group, gather_rows, process_count,
                                             reduce_gradients)


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
        if process_count() > 1:
            # one text length for the global batch: the max over the
            # processes of their buckets is the bucket of the global
            # longest text (the bucket map is monotone)
            target = all_reduce_max_int(target)
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
    if "sample_valid" in batch:
        arrays["sample_valid"] = batch["sample_valid"]
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


def _global_batch(out, batch, group, valid=None):
    """The loss's inputs over the global batch: the embeddings (in f32, as
    the losses read them), the region mask, the text mask and the eval
    validity flags of every data rank, in rank order."""
    out = dict(out)
    for k in ("global_text_embeddings", "global_object_embeddings",
              "local_object_embeddings", "local_text_embeddings"):
        out[k] = gather_rows(out[k].float(), group)
    out["object_mask"] = gather_rows(out["object_mask"], group)
    batch = {"attention_mask": gather_rows(batch["attention_mask"], group)}
    return out, batch, (None if valid is None else gather_rows(valid, group))


def dropout_key(seed: int, step: int, rank: int) -> int:
    """The 64-bit seed of the dropout generator of optimizer step `step`
    on data rank `rank`."""
    state = np.random.SeedSequence([int(seed), int(step), int(rank)]).generate_state(
        1, dtype=np.uint64)
    return int(state[0])


def dropout_scope(seed: int, rank: int, step_count: Callable[[], int], deterministic: bool):
    """A context manager factory for the train steps: `with make(device):`
    seeds torch's default CPU generator and `device`'s default generator
    with dropout_key(seed, step_count(), rank) and restores both states on
    exit; a no-op when `deterministic`."""

    @contextmanager
    def make(device: torch.device):
        if deterministic:
            yield
            return
        gens = [torch.default_generator]
        if device.type == "cuda":
            index = torch.cuda.current_device() if device.index is None else device.index
            gens.append(torch.cuda.default_generators[index])
        saved = [g.get_state() for g in gens]
        key = dropout_key(seed, step_count(), rank)
        for g in gens:
            g.manual_seed(key)
        try:
            yield
        finally:
            for g, state in zip(gens, saved):
                g.set_state(state)

    return make


def mlm_loss_fn(logits, labels, ignore_index: int = -100, group=None):
    """Masked-LM cross-entropy (f32) averaged over the positions whose label
    is not `ignore_index`; 0 where there are none. With a data group the
    denominator is the count over the global batch, so the group's terms
    sum to the global loss."""
    logits = logits.float()
    valid = (labels != ignore_index).float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
    return torch.sum(nll * valid) / torch.clamp(all_reduce_sum(torch.sum(valid), group), min=1.0)


def make_retrieval_train_step(model: torch.nn.Module, loss_obj, optimizer,
                              deterministic: bool = False,
                              mlm_weight: float = 0.0, mesh=None,
                              dropout_seed: int = 0) -> Callable:
    """step(batch, lr) -> metrics (device scalars): forward (dropout on
    unless `deterministic`, keyed by `dropout_seed` as the module docstring
    says), losses, backward, one AdamW update at `lr`.
    With `mlm_weight` the model's MLM head runs on the masked text and
    mlm_weight * mlm_loss_fn(logits, batch["mlm_labels"]) joins the total;
    `mlm_loss` is 0 otherwise. The gradients stay in `p.grad` until the
    next step. With a data-parallel `mesh` the step is the global-batch
    step of the module docstring; the metrics are the global ones."""
    group = data_group(mesh)
    dropout = dropout_scope(dropout_seed, data_coords(mesh)[0],
                            lambda: optimizer.step_count, deterministic)

    def step(batch: Dict[str, torch.Tensor], lr: float) -> Dict[str, torch.Tensor]:
        model.train(not deterministic)
        optimizer.set_lr(lr)
        optimizer.zero_grad(set_to_none=True)
        with dropout(batch["input_ids"].device):
            out = model(batch, mlm=True) if mlm_weight else model(batch)
        if group is None:
            total, g, l = retrieval_losses(loss_obj, out, batch)
        else:
            total, g, l = retrieval_losses(loss_obj, *_global_batch(out, batch, group)[:2])
        if mlm_weight:
            mlm = mlm_loss_fn(out["mlm_logits"], batch["mlm_labels"], group=group)
            total = total + mlm_weight * mlm
        else:
            mlm = torch.zeros((), dtype=torch.float32, device=total.device)
        total.backward()
        reduce_gradients(model.parameters(), group)
        optimizer.step()
        if group is not None and mlm_weight:
            # this rank's total holds only its share of the MLM term
            mlm_all = all_reduce_sum(mlm, group)
            total = total.detach() + mlm_weight * (mlm_all - mlm.detach())
            mlm = mlm_all
        return {"loss": total.detach(), "global_loss": g.detach(), "local_loss": l.detach(),
                "mlm_loss": mlm.detach()}

    return step


def make_retrieval_eval_step(model: torch.nn.Module, loss_obj, mesh=None) -> Callable:
    """step(batch) -> (embedding dict, (total, global, local)). An optional
    batch["valid"] (B,) 0/1 mask excludes pad rows from the loss. With a
    data-parallel `mesh` the loss is over the global batch (every rank's
    valid rows); the embeddings returned are this rank's."""
    group = data_group(mesh)

    @torch.inference_mode()
    def step(batch: Dict[str, torch.Tensor]):
        batch = dict(batch)
        valid = batch.pop("valid", None)
        model.eval()
        out = dict(model(batch))
        if group is None:
            losses = retrieval_losses(loss_obj, out, batch, valid)
        else:
            losses = retrieval_losses(loss_obj, *_global_batch(out, batch, group, valid))
        out["text_mask_add"] = additive_mask(batch["attention_mask"][:, 1:])
        out["text_length"] = torch.sum(batch["attention_mask"], dim=1).to(torch.int32)
        return out, losses

    return step


def make_qa_train_step(model: torch.nn.Module, loss_obj, optimizer,
                       deterministic: bool = False, mesh=None,
                       dropout_seed: int = 0) -> Callable:
    """step(batch, lr) -> {"loss", "correct"} (device scalars): forward
    (dropout on unless `deterministic`, keyed by `dropout_seed` as the
    module docstring says), cross-entropy on the logits,
    backward, one AdamW update; `correct` counts argmax hits. With a
    data-parallel `mesh` the loss is the mean over the global batch (the
    data ranks' batches are equal) and both metrics are global."""
    group = data_group(mesh)
    ranks = 1 if group is None else torch.distributed.get_world_size(group)
    dropout = dropout_scope(dropout_seed, data_coords(mesh)[0],
                            lambda: optimizer.step_count, deterministic)

    def step(batch: Dict[str, torch.Tensor], lr: float) -> Dict[str, torch.Tensor]:
        model.train(not deterministic)
        optimizer.set_lr(lr)
        optimizer.zero_grad(set_to_none=True)
        with dropout(batch["input_ids"].device):
            logits = model(batch)["logits"]
        loss = loss_obj(logits, batch["label"])
        if group is not None:
            loss = loss / ranks  # this rank's share of the global mean
        loss.backward()
        reduce_gradients(model.parameters(), group)
        optimizer.step()
        correct = torch.sum((torch.argmax(logits, dim=-1) == batch["label"]).float())
        return {"loss": all_reduce_sum(loss.detach(), group),
                "correct": all_reduce_sum(correct.detach(), group)}

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
