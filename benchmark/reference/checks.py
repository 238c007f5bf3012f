"""The reference's side of each cell's comparison, and the comparison.

Training: the reference takes the same starting weights and the same
inputs (made again from the seed: data.py) through the first three
steps, with the dropout masks drawn as the configuration's model draws
them (torch's default generator of the device seeded per step with
(seed, step, data rank), one mask per dropout site in the layers' order,
each of the dtype the site sees: the embeddings' float32, the compute
dtype after). Compared, each by its worst case:

  loss_gap    |loss - ref| / |ref| over the three steps;
  grad_gap    per leaf, | |g| - |g_ref| | of the first step's gradient
              (the program's from its optimizer's first moment after one
              step, m / (1 - b1)), over max(|g_ref| of the leaf, of the
              median leaf);
  update_gap  per leaf, | |p3 - p0| - |p3 - p0|_ref | after three steps,
              over max(that leaf's, the median leaf's reference change).
              The norms leave out every entry whose reference gradient at
              the first step is under a thousandth of the median leaf's
              root-mean-square gradient: such entries (a key's bias under
              softmax, which a fused q/k/v bias holds beside entries that
              move) take a gradient of round-off alone, which Adam scales
              up to a full step.

The local stage alone (both local-similarity kernels, forward and
backward), followed from the program's own state: at each compared step
the reference takes the two local embeddings and masks that the program's
towers handed its local similarity, and the gradient that its loss handed
back to the scores, and works the scores and the embeddings' gradients
out again in float64:

  local_score_gap  the mean over every (video, caption) pair of
                   |score - ref|, worst step;
  local_grad_gap   |g - g_ref| / |g_ref| of either embedding's gradient
                   (the norm of the difference), worst step.

The towers' rounding, which the numbers above read, does not enter these,
so a local stage computed below its stated precision shows in them.

Serving: the reference embeds the index's videos and the checked calls'
queries, scores every (query, video) pair, and compares each returned
top-k entry:

  score_gap   |returned score - reference score of that pair|;
  rank_gap    how far the reference's score of a returned video lies below
              the reference's k-th best score for that query (0 when it is
              among the reference's top k or tied with it);
  local_gap   the scoring stage alone, from the program's own embeddings:
              the mean over every (query, video) pair of the checked calls
              of |score - the score worked out again in float64 from the
              query and index embeddings the program scored|. A mean, as a
              pair near the focal threshold flips in its widest gap by
              round-off alone.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import data, losses, model
from benchmark.reference.precision import exact

Op = Callable[[torch.Tensor], torch.Tensor]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MOVED_SHARE = 1e-3  # leaves under this share of the median gradient do not count as moved


def dropout_key(seed: int, step: int, rank: int = 0) -> int:
    return int(np.random.SeedSequence([int(seed), int(step), int(rank)]).generate_state(
        1, dtype=np.uint64)[0])


def dropout_masks(w: model.Widths, batch: int, length: int, compute: torch.dtype,
                  device: torch.device, key: int) -> List[torch.Tensor]:
    """The 0 / 1 keep-masks of one text-tower forward, drawn from the
    device's default generator seeded with `key` (its state restored)."""
    gen = (torch.cuda.default_generators[device.index if device.index is not None
                                         else torch.cuda.current_device()]
           if device.type == "cuda" else torch.default_generator)
    state = gen.get_state()
    gen.manual_seed(key)
    try:
        out = []
        for i, (shape, which) in enumerate(model.dropout_shapes(w, batch, length)):
            p = w.attention_dropout if which == "a" else w.dropout
            ones = torch.ones(shape, dtype=torch.float32 if i == 0 else compute, device=device)
            out.append((F.dropout(ones, p, training=True) != 0).float())
        return out
    finally:
        gen.set_state(state)


def loss_args(cfg: dict) -> dict:
    a = cfg["loss"].get("args", {})
    return {"temperature": float(a.get("temperature", 0.05)),
            "lam": float(a.get("lambda_softmax", 20.0)),
            "focal_equal": a.get("focal_type", "prob") == "equal"}


def _device_arrays(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


def tap_local(im: torch.Tensor, s: torch.Tensor, im_mask: torch.Tensor, s_mask: torch.Tensor):
    """(im, s, record): views of the local similarity's two embeddings to
    compute the scores from, and a record of its inputs into which the
    backward writes each view's gradient (`g_im`, `g_s`); the caller hands
    the scores to tap_scores."""
    rec = {"im": im.detach().float().clone(), "s": s.detach().float().clone(),
           "im_mask": im_mask.detach().float().clone(), "s_mask": s_mask.detach().float().clone()}
    im, s = im.view_as(im), s.view_as(s)
    for key, t in (("g_im", im), ("g_s", s)):
        if t.requires_grad:
            t.register_hook(lambda g, key=key: rec.__setitem__(key, g.detach().float().clone()))
    return im, s, rec


def tap_scores(rec: dict, scores: torch.Tensor) -> None:
    """Records the scores, and the gradient that the backward hands them
    (`g_scores`)."""
    rec["scores"] = scores.detach().float().clone()
    if scores.requires_grad:
        scores.register_hook(lambda g: rec.__setitem__("g_scores", g.detach().float().clone()))


def step_loss(P, w, b: Dict[str, torch.Tensor], la: dict, op_t: Op, op_l: Op,
              masks: Optional[List[torch.Tensor]], record: Optional[list] = None) -> torch.Tensor:
    """The step's loss; with `record`, the local stage's record (tap_local)
    is appended to it."""
    g_t, l_t = model.text_tower(P, w, b["input_ids"], b["attention_mask"],
                                None if masks is None else iter(masks), op_t)
    g_o, l_o, o_mask = model.object_tower(P, w, b["object"], b["object_mask"], op_t)
    glob = losses.info_nce(losses.cosine_matrix(g_t, g_o), la["temperature"])
    t_mask = (b["attention_mask"][:, 1:].float() - 1.0) * 100.0
    if record is not None:
        l_o, l_t, rec = tap_local(l_o, l_t, o_mask, t_mask)
    scores = losses.local_scores(l_o, l_t, o_mask, t_mask, la["lam"], la["focal_equal"], op_l)
    if record is not None:
        tap_scores(rec, scores)
        record.append(rec)
    return glob + losses.rwa_loss(scores, la["lam"])


def reference_train(cfg: dict, seed: int, batches: Sequence[Dict[str, np.ndarray]],
                    p0: Dict[str, torch.Tensor], device: torch.device, op_t: Op = exact,
                    op_l: Op = exact, half_batch: bool = False,
                    record: Optional[list] = None) -> dict:
    """{losses, grad_norms, delta_norms} of the reference's first steps from
    the weights p0 (host or device tensors by name), one step a batch.
    `half_batch` is a planted fault: the loss over the first half of the
    rows only. With `record`, each step's local stage is recorded there
    (tap_local)."""
    w = model.Widths.from_config(cfg)
    la = loss_args(cfg)
    compute = DTYPES[cfg.get("precision", {}).get("compute", "float32")]
    oa = cfg["optimizer"].get("args", {})
    names = sorted(p0)
    P = {n: p0[n].detach().to(device, torch.float32).clone().requires_grad_(True) for n in names}
    opt = losses.AdamW(P, lr=float(oa["lr"]), b1=float(oa.get("b1", 0.9)),
                       b2=float(oa.get("b2", 0.999)), eps=float(oa.get("eps", 1e-6)),
                       weight_decay=float(oa.get("weight_decay", 0.0)))
    out = {"losses": [], "grad_norms": None, "g1": None, "names": names}
    for step, arrays in enumerate(batches):
        b = _device_arrays(arrays, device)
        n, length = b["input_ids"].shape
        masks = dropout_masks(w, n, length, compute, device, dropout_key(seed, step))
        if half_batch:
            b = {k: v[: n // 2] for k, v in b.items()}
            masks = [m[: n // 2] for m in masks]
        loss = step_loss(P, w, b, la, op_t, op_l, masks, record)
        grads = torch.autograd.grad(loss, [P[k] for k in names], allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(P[k])) for k, g in zip(names, grads)}
        if step == 0:
            out["grad_norms"] = losses.leaf_norms(grads, names)
            out["g1"] = grads
        opt.step(grads)
        out["losses"].append(float(loss.detach()))
        del loss, grads, masks, b
    out["p3"] = {k: v.detach() for k, v in P.items()}
    return out


def update_norms(p3: Dict[str, torch.Tensor], ref: dict, p0: Dict[str, torch.Tensor]):
    """Per leaf, |p3 - p0| of `p3` (the program's or the reference's own
    weights after the compared steps) over the entries that count as moved
    (module docstring); leaves with none are left out (None)."""
    names = ref["names"]
    g1 = ref["g1"]
    rms = [float(torch.linalg.vector_norm(g1[k].double())) / max(1, g1[k].numel()) ** 0.5
           for k in names]
    floor = MOVED_SHARE * float(np.median(rms))
    out = []
    with torch.no_grad():
        for k in names:
            keep = g1[k].abs() >= floor
            if not bool(keep.any()):
                out.append(None)
                continue
            dev = g1[k].device
            d = (p3[k].to(dev, torch.float32) - p0[k].to(dev, torch.float32))[keep]
            out.append(float(torch.linalg.vector_norm(d.double())))
    return out


def _leaf_gaps(got: Sequence[Optional[float]], want: Sequence[Optional[float]]) -> List[float]:
    """Per leaf | got - want | over max(want, the median leaf's want); None
    where the reference has no reading."""
    med = float(np.median([r for r in want if r is not None]))
    return [None if r is None else abs(g - r) / max(r, med) for g, r in zip(got, want)]


def _worst(gaps: Sequence[Optional[float]]) -> float:
    return max(g for g in gaps if g is not None)


def compare_train(prog: dict, ref: dict, p0: Dict[str, torch.Tensor], detail: Optional[dict] = None
                  ) -> Dict[str, float]:
    """The three numbers of the module docstring; `prog` holds the program's
    losses, first-step gradient norms and weights after the compared steps
    (`p3`), `ref` what reference_train returns. With `detail`, each step's
    loss gap and the leaves with the largest gaps are put there."""
    names = ref["names"]
    if prog["names"] != names:
        raise ValueError("the program's leaves and the reference's differ")
    loss = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    grad = _leaf_gaps(prog["grad_norms"], ref["grad_norms"])
    update = _leaf_gaps(update_norms(prog["p3"], ref, p0), update_norms(ref["p3"], ref, p0))
    if detail is not None:
        def top(gaps):
            ranked = sorted(((g, n) for g, n in zip(gaps, names) if g is not None), reverse=True)
            return [[n, g] for g, n in ranked[:3]]
        detail.update(loss_by_step=loss, grad_top=top(grad), update_top=top(update),
                      grad_median=float(np.median([g for g in grad if g is not None])),
                      update_median=float(np.median([g for g in update if g is not None])))
    return {"loss_gap": max(loss), "grad_gap": _worst(grad), "update_gap": _worst(update)}


def local_stage(rec: dict, la: dict, device):
    """(scores, d im, d s) of the local similarity from a record's inputs,
    the gradients those of the record's `g_scores`, in float64 on
    `device`."""
    im, s, im_mask, s_mask, g_scores = (rec[k].to(device, torch.float64)
                                        for k in ("im", "s", "im_mask", "s_mask", "g_scores"))
    im.requires_grad_(True)
    s.requires_grad_(True)
    with torch.enable_grad():
        scores = losses.local_scores(im, s, im_mask, s_mask, la["lam"], la["focal_equal"])
        g_im, g_s = torch.autograd.grad(scores, [im, s], grad_outputs=g_scores)
    return scores.detach(), g_im, g_s


def compare_local(records: Sequence[dict], la: dict, device) -> Dict[str, float]:
    """local_score_gap and local_grad_gap (module docstring) over the
    records of the compared steps; a record whose backward handed no
    gradient over reads infinite."""
    score, grad = [], []
    for rec in records:
        if not all(k in rec for k in ("g_scores", "g_im", "g_s")):
            score.append(float("inf"))
            continue
        want, g_im, g_s = local_stage(rec, la, device)
        score.append(float((rec["scores"].to(device, torch.float64) - want).abs().mean()))
        for key, g in (("g_im", g_im), ("g_s", g_s)):
            grad.append(float(torch.linalg.vector_norm(rec[key].to(device, torch.float64) - g)
                              / torch.linalg.vector_norm(g)))
    return {"local_score_gap": max(score), "local_grad_gap": max(grad, default=float("inf"))}


# ---- serving


@torch.no_grad()
def embed_index(P, w: model.Widths, inputs: data.Inputs, device, op: Op = exact, block: int = 50):
    """(g_o, l_o, o_mask) of every sample of `inputs`, in order."""
    g, l, m = [], [], []
    for s in range(0, inputs.n, block):
        feats, masks = zip(*(inputs.sample(i) for i in range(s, min(s + block, inputs.n))))
        go, lo, om = model.object_tower(P, w, torch.from_numpy(np.stack(feats)).to(device),
                                        torch.from_numpy(np.stack(masks)).to(device), op)
        g.append(go)
        l.append(lo)
        m.append(om)
    return torch.cat(g), torch.cat(l), torch.cat(m)


@torch.no_grad()
def embed_queries(P, w: model.Widths, texts: Sequence[str], device, op: Op = exact):
    """(g_t, l_t, additive word mask) of the query texts."""
    tok = _device_arrays(data.tokenize(list(texts)), device)
    g_t, l_t = model.text_tower(P, w, tok["input_ids"], tok["attention_mask"], None, op)
    return g_t, l_t, (tok["attention_mask"][:, 1:].float() - 1.0) * 100.0


@torch.no_grad()
def score(queries, index, la: dict, op: Op = exact, block: int = 64) -> torch.Tensor:
    """(n_queries, n_videos) scores of embedded queries against an embedded
    index: global cosine plus the local score of (video, query), transposed."""
    g_t, l_t, t_mask = queries
    g_o, l_o, o_mask = index
    local = losses.local_scores(l_o, l_t, o_mask, t_mask, la["lam"], la["focal_equal"], op,
                                block=block)
    return losses.cosine_matrix(g_t, g_o) + local.T


def query_sims(P, w: model.Widths, texts: Sequence[str], index, la: dict, device,
               op_t: Op = exact, op_l: Op = exact) -> torch.Tensor:
    """(n_queries, n_videos) reference scores of the texts against an index."""
    return score(embed_queries(P, w, texts, device, op_t), index, la, op_l)


@torch.no_grad()
def scoring_gap(sims, queries, index, la: dict, device) -> float:
    """local_gap (module docstring): the mean |sims - the scores of the
    same query and index embeddings, worked out in float64|."""
    def f64(x):
        return torch.as_tensor(x).to(device, torch.float64)

    want = score(tuple(map(f64, queries)), tuple(map(f64, index)), la)
    return float((f64(sims) - want).abs().mean())


def malformed(row: dict, k: int, n_videos: int) -> bool:
    """A result row that is not k distinct in-range videos with finite scores."""
    idx = list(row.get("topk_indices", []))
    scores = list(row.get("topk_scores", []))
    return (len(idx) != k or len(set(idx)) != k or len(scores) != k
            or not all(0 <= int(i) < n_videos for i in idx) or not all(np.isfinite(scores)))


def compare_query(results: Sequence[Sequence[dict]], ref_sims: np.ndarray, k: int):
    """({score_gap, rank_gap}, malformed count) over the checked calls'
    results; ref_sims rows follow the calls' queries in order."""
    score_gap, rank_gap, bad = 0.0, 0.0, 0
    rows = [r for call in results for r in call]
    if len(rows) != ref_sims.shape[0]:
        raise ValueError(f"{len(rows)} results against {ref_sims.shape[0]} reference rows")
    n_videos = ref_sims.shape[1]
    for row, r in zip(rows, ref_sims):
        if malformed(row, k, n_videos):
            bad += 1
            continue
        idx, scores = row["topk_indices"], row["topk_scores"]
        kth = float(np.sort(r)[-k])
        for i, s in zip(idx, scores):
            score_gap = max(score_gap, abs(float(s) - float(r[int(i)])))
            rank_gap = max(rank_gap, kth - float(r[int(i)]))
    return {"score_gap": score_gap, "rank_gap": rank_gap}, bad
