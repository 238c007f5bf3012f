"""All-pairs local-similarity evaluation on one card (counterpart of
demovlp_tpu/parallel/sharded_eval.py::sharded_local_sims, without a mesh).

The gallery (video) axis is processed in host-level chunks of `chunk_rows`
rows (default 4096) and the caption axis in blocks of `cap_chunk_rows`
(default 8192), as in the JAX package; a short last chunk or block is
padded with inert rows (zero features, all -100 mask) whose results are
dropped. Each caption block goes to the card once and is reused by every
gallery chunk; the next gallery chunk is padded and uploaded while the
current one's kernels run. Inputs are cast to f32, so the kernel runs in
its f32 mode.
"""
from __future__ import annotations

import numpy as np
import torch

from demovlp_tpu_torch.device import to_device
from demovlp_tpu_torch.ops.xattn_kernel import xattn_score_kernel


def _pad_rows(feats: np.ndarray, mask: np.ndarray, n: int):
    """Pad (feats, additive mask) to n rows with inert -100 rows."""
    k = feats.shape[0]
    if k == n:
        return feats, mask
    fp = np.zeros((n,) + feats.shape[1:], np.float32)
    fp[:k] = feats
    mp = np.full((n, mask.shape[1]), -100.0, np.float32)
    mp[:k] = mask
    return fp, mp


def sharded_local_sims(img_feats, lang_feats, img_mask, lang_mask, *,
                       device, lambda_softmax: float = 20.0,
                       focal_type: str = "prob", chunk_rows: int = 4096,
                       cap_chunk_rows: int = 8192) -> np.ndarray:
    """(n_videos, n_texts) local similarity matrix as f32 numpy.

    img_feats (Ni, R, D), lang_feats (Nc, W, D), additive masks (Ni, R) and
    (Nc, W), as host arrays."""
    device = torch.device(device)
    img_feats = np.asarray(img_feats, dtype=np.float32)
    lang_feats = np.asarray(lang_feats, dtype=np.float32)
    img_mask = np.asarray(img_mask, dtype=np.float32)
    lang_mask = np.asarray(lang_mask, dtype=np.float32)
    n_img, n_cap = img_feats.shape[0], lang_feats.shape[0]
    out = np.empty((n_img, n_cap), dtype=np.float32)
    if n_img == 0 or n_cap == 0:
        return out
    chunk = min(n_img, chunk_rows)
    starts = list(range(0, n_img, chunk))

    def stage(start: int):
        stop = min(start + chunk, n_img)
        f, m = _pad_rows(img_feats[start:stop], img_mask[start:stop], chunk)
        return to_device(f, device), to_device(m, device)

    # caption blocks: padded to the block shape only when there is more
    # than one block, as the JAX package does
    cap_block = n_cap if n_cap <= cap_chunk_rows else cap_chunk_rows
    for cs in range(0, n_cap, cap_block):
        ce = min(cs + cap_block, n_cap)
        lf, lm = _pad_rows(lang_feats[cs:ce], lang_mask[cs:ce], cap_block)
        lang_dev, lmask_dev = to_device(lf, device), to_device(lm, device)
        staged = stage(starts[0])
        for i, start in enumerate(starts):
            feats_dev, mask_dev = staged
            sims = xattn_score_kernel(feats_dev, lang_dev, mask_dev, lmask_dev,
                                      lambda_softmax, focal_type)
            if i + 1 < len(starts):  # next chunk's upload overlaps these kernels
                staged = stage(starts[i + 1])
            stop = min(start + chunk, n_img)
            out[start:stop, cs:ce] = sims[: stop - start, : ce - cs].cpu().numpy()
    return out
