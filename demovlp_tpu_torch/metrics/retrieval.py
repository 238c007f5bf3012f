"""Retrieval metrics on similarity matrices, host-side numpy (copy of
demovlp_tpu/metrics/retrieval.py).

  * t2v: distances ranked per text query, ties broken OPTIMISTICALLY by
    default ("averaging" available); with num_queries = k * num_vids, text
    query i's ground-truth video is i // k.
  * v2t: for each video, the rank of the closest of its captions, ties
    broken by AVERAGING by default.
  * query_masks mark missing captions.
"""
from __future__ import annotations

import numpy as np


def t2v_metrics(sims, query_masks=None, break_ties: str = "optimistically"):
    """Text-to-video metrics of a (num_queries, num_vids) similarity matrix."""
    sims = np.asarray(sims)
    assert sims.ndim == 2, "expected a matrix"
    num_queries, num_vids = sims.shape
    dists = -sims
    sorted_dists = np.sort(dists, axis=1)
    queries_per_video = num_queries // num_vids
    gt_idx = np.repeat(np.arange(num_vids, dtype=np.int64), queries_per_video)
    gt_dists = dists[np.arange(num_queries), gt_idx][:, np.newaxis]
    rows, cols = np.where((sorted_dists - gt_dists) == 0)
    if rows.size > num_queries:
        assert np.unique(rows).size == num_queries, "issue in metric evaluation"
        if break_ties == "optimistically":
            _, idx = np.unique(rows, return_index=True)
            cols = cols[idx]
        elif break_ties == "averaging":
            locs = np.argwhere((sorted_dists - gt_dists) == 0)
            steps = np.diff(locs[:, 0])
            splits = np.insert(np.nonzero(steps)[0] + 1, 0, 0)
            summed_cols = np.add.reduceat(locs[:, 1], splits)
            counts = np.diff(np.append(splits, locs.shape[0]))
            cols = summed_cols / counts
        else:
            raise ValueError(break_ties)
    assert cols.size == num_queries, (
        f"expected ranks to match queries ({cols.size} vs {num_queries})")
    if query_masks is not None:
        assert query_masks.size == num_queries, "invalid query mask shape"
        cols = cols[np.asarray(query_masks).reshape(-1).astype(bool)]
        assert cols.size == query_masks.sum(), "masking was not applied correctly"
        num_queries = int(query_masks.sum())
    return cols2metrics(cols, num_queries)


def v2t_metrics(sims, query_masks=None, break_ties: str = "averaging"):
    """Video-to-text metrics: rank of the closest ground-truth caption.
    `sims` has the same (num_texts, num_vids) orientation as t2v_metrics."""
    sims = np.asarray(sims).T
    assert sims.ndim == 2, "expected a matrix"
    num_queries, num_caps = sims.shape
    dists = -sims.copy()
    caps_per_video = num_caps // num_queries
    missing = 1e8
    if query_masks is not None:
        invalid = np.logical_not(np.asarray(query_masks).reshape(-1).astype(bool))
    query_ranks = []
    for ii in range(num_queries):
        row_dists = dists[ii, :]
        if query_masks is not None:
            row_dists[invalid] = missing
        sorted_dists = np.sort(row_dists)
        min_rank = np.inf
        for jj in range(ii * caps_per_video, (ii + 1) * caps_per_video):
            if row_dists[jj] == missing:
                continue
            ranks = np.where((sorted_dists - row_dists[jj]) == 0)[0]
            if break_ties == "optimistically":
                rank = ranks[0]
            elif break_ties == "averaging":
                rank = ranks.mean()
            else:
                raise ValueError(break_ties)
            min_rank = min(min_rank, rank)
        query_ranks.append(min_rank)
    return cols2metrics(np.array(query_ranks), num_queries)


def cols2metrics(cols, num_queries):
    """Rank vector -> R@1/5/10/50, MedR, MeanR and the geometric mean of
    R@1, R@5 and R@10 (0 when any of them is 0)."""
    cols = np.asarray(cols)
    metrics = {
        "R1": 100 * float(np.sum(cols == 0)) / num_queries,
        "R5": 100 * float(np.sum(cols < 5)) / num_queries,
        "R10": 100 * float(np.sum(cols < 10)) / num_queries,
        "R50": 100 * float(np.sum(cols < 50)) / num_queries,
        "MedR": float(np.median(cols) + 1),
        "MeanR": float(np.mean(cols) + 1),
    }
    stats = np.asarray([metrics[x] for x in ("R1", "R5", "R10")])
    with np.errstate(divide="ignore"):
        metrics["geometric_mean_R1-R5-R10"] = float(np.exp(np.mean(np.log(stats))))
    return metrics


METRICS = {fn.__name__: fn for fn in (t2v_metrics, v2t_metrics)}
