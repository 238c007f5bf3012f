"""The reference's side of a data-parallel cell's comparison: the global
batch of every rank's shard, its dropout masks and the local stage in
blocks.

The program's ranks each read their shard of one epoch order (its
loader: the epoch's permutation truncated to a multiple of the ranks,
rank r taking every ranks-th index from r) and draw the text tower's
dropout masks from their own device's generator seeded with (seed, step,
data rank). The reference takes the global batch, the ranks' rows in rank
order, and draws each rank's masks with that rank's key, so its three
steps over the global batch are the program's. Over the global batch the
local similarity's intermediates ((B, B, words, 256) in float32) do not
fit on a card at once, so the reference's steps and the check of the
program's local stage (whose records cover the gathered batch: every rank
scores it) work it out in blocks of rows, each block's scores and
gradients exactly those of the full computation. The controls
(control_dp.py) take the same steps with the towers' and the local
stage's product operands rounded (`op_t`, `op_l`; a per-tensor scale is
then one block's).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from benchmark.reference import checks, data, losses, model
from benchmark.reference.precision import Op, exact


def global_batches(inputs: data.Inputs, seed: int, ranks: int, per_rank: int,
                   steps: int) -> List[Dict[str, np.ndarray]]:
    """The first `steps` global batches of epoch 1: each rank's batch, in
    rank order."""
    order = data.train_order(seed, 1, inputs.n)
    order = order[:inputs.n // ranks * ranks]
    shards = [order[r::ranks] for r in range(ranks)]
    return [inputs.batch(np.concatenate([sh[i * per_rank:(i + 1) * per_rank] for sh in shards]))
            for i in range(steps)]


def masks(w: model.Widths, per_rank: int, length: int, compute, device, seed: int, step: int,
          ranks: int) -> List[torch.Tensor]:
    """The text tower's dropout masks of one global step: each rank's, drawn
    with its key, concatenated over the batch axis in rank order."""
    drawn = [checks.dropout_masks(w, per_rank, length, compute, device,
                                  checks.dropout_key(seed, step, r)) for r in range(ranks)]
    return [torch.cat(site, 0) for site in zip(*drawn)]


def blocked_local(im, s, im_mask, s_mask, la: dict, block: int, g_scores=None,
                  op: Op = exact):
    """(scores, d im, d s) of the local similarity (losses.local_scores) in
    blocks of `block` rows a side, in the inputs' dtype: each block's
    scores are those of the full computation (every pair is scored on its
    own), and each block's backward, given `g_scores`, adds its share to
    the two gradients (None without `g_scores`)."""
    scores = torch.zeros((im.shape[0], s.shape[0]), dtype=im.dtype, device=im.device)
    g_im = None if g_scores is None else torch.zeros_like(im)
    g_s = None if g_scores is None else torch.zeros_like(s)
    for i in range(0, im.shape[0], block):
        for j in range(0, s.shape[0], block):
            a = im[i:i + block].detach().clone().requires_grad_(g_scores is not None)
            c = s[j:j + block].detach().clone().requires_grad_(g_scores is not None)
            with torch.enable_grad() if g_scores is not None else torch.no_grad():
                sc = losses.local_scores(a, c, im_mask[i:i + block], s_mask[j:j + block],
                                         la["lam"], la["focal_equal"], op)
                if g_scores is not None:
                    ga, gc = torch.autograd.grad(
                        sc, [a, c], grad_outputs=g_scores[i:i + block, j:j + block])
                    g_im[i:i + block] += ga
                    g_s[j:j + block] += gc
            scores[i:i + block, j:j + block] = sc.detach()
    return scores, g_im, g_s


def loss_and_grads(P, w: model.Widths, b: Dict[str, torch.Tensor], la: dict,
                   m: List[torch.Tensor], names: List[str], block: int, op_t: Op = exact,
                   op_l: Op = exact, record: Optional[list] = None):
    """(loss, {name: gradient}) of checks.step_loss, its local stage worked
    out in blocks: the scores without a graph, the loss's gradient with
    respect to them, then each block's backward to the two local
    embeddings and one backward of the towers. With `record`, the local
    stage's record (checks.tap_local's keys) is appended to it."""
    g_t, l_t = model.text_tower(P, w, b["input_ids"], b["attention_mask"], iter(m), op_t)
    g_o, l_o, o_mask = model.object_tower(P, w, b["object"], b["object_mask"], op_t)
    t_mask = (b["attention_mask"][:, 1:].float() - 1.0) * 100.0
    scores, _, _ = blocked_local(l_o, l_t, o_mask, t_mask, la, block, op=op_l)
    scores.requires_grad_(True)
    loss = (losses.info_nce(losses.cosine_matrix(g_t, g_o), la["temperature"])
            + losses.rwa_loss(scores, la["lam"]))
    d_scores, = torch.autograd.grad(loss, [scores], retain_graph=True)
    _, d_lo, d_lt = blocked_local(l_o, l_t, o_mask, t_mask, la, block, d_scores, op_l)
    if record is not None:
        record.append({k: v.detach().float().clone() for k, v in (
            ("im", l_o), ("s", l_t), ("im_mask", o_mask), ("s_mask", t_mask),
            ("scores", scores), ("g_scores", d_scores), ("g_im", d_lo), ("g_s", d_lt))})
    grads = torch.autograd.grad([loss, l_o, l_t], [P[k] for k in names],
                                grad_outputs=[torch.ones_like(loss), d_lo, d_lt],
                                allow_unused=True)
    return loss.detach(), {k: (g if g is not None else torch.zeros_like(P[k]))
                           for k, g in zip(names, grads)}


def reference_train(cfg: dict, seed: int, batches: Sequence[Dict[str, np.ndarray]],
                    p0: Dict[str, torch.Tensor], device: torch.device, ranks: int,
                    block: int, op_t: Op = exact, op_l: Op = exact,
                    record: Optional[list] = None) -> dict:
    """checks.reference_train over global batches, with each rank's masks
    and the local stage in blocks of `block` rows; with `record`, each
    step's local stage is recorded there."""
    w = model.Widths.from_config(cfg)
    la = checks.loss_args(cfg)
    compute = checks.DTYPES[cfg.get("precision", {}).get("compute", "float32")]
    oa = cfg["optimizer"].get("args", {})
    names = sorted(p0)
    P = {n: p0[n].detach().to(device, torch.float32).clone().requires_grad_(True) for n in names}
    opt = losses.AdamW(P, lr=float(oa["lr"]), b1=float(oa.get("b1", 0.9)),
                       b2=float(oa.get("b2", 0.999)), eps=float(oa.get("eps", 1e-6)),
                       weight_decay=float(oa.get("weight_decay", 0.0)))
    out = {"losses": [], "grad_norms": None, "g1": None, "names": names}
    for step, arrays in enumerate(batches):
        b = checks._device_arrays(arrays, device)
        n, length = b["input_ids"].shape
        m = masks(w, n // ranks, length, compute, device, seed, step, ranks)
        loss, grads = loss_and_grads(P, w, b, la, m, names, block, op_t, op_l, record)
        if step == 0:
            out["grad_norms"] = losses.leaf_norms(grads, names)
            out["g1"] = grads
        opt.step(grads)
        out["losses"].append(float(loss))
        del loss, grads, m, b
    out["p3"] = {k: v.detach() for k, v in P.items()}
    return out


def compare_local(records: Sequence[dict], la: dict, device, block: int) -> Dict[str, float]:
    """checks.compare_local, the local stage worked out in float64 in
    blocks."""
    score, grad = [], []
    for rec in records:
        if not all(k in rec for k in ("g_scores", "g_im", "g_s")):
            score.append(float("inf"))
            continue
        im, s, im_mask, s_mask, g_scores = (rec[k].to(device, torch.float64) for k in
                                            ("im", "s", "im_mask", "s_mask", "g_scores"))
        want, g_im, g_s = blocked_local(im, s, im_mask, s_mask, la, block, g_scores)
        score.append(float((rec["scores"].to(device, torch.float64) - want).abs().mean()))
        for key, g in (("g_im", g_im), ("g_s", g_s)):
            grad.append(float(torch.linalg.vector_norm(rec[key].to(device, torch.float64) - g)
                              / torch.linalg.vector_norm(g)))
    return {"local_score_gap": max(score), "local_grad_gap": max(grad, default=float("inf"))}
