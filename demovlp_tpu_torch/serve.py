"""Offline embedding extraction + retrieval index on one card (counterpart
of demovlp_tpu/serve.py: `make_embed_step`, `embed_loader`,
`combined_sims`, `topk_retrieval`, `load_index`).

Semantics follow the JAX serving path: the same embedding dict, pad rows
of the last batch dropped, and the combined matrix keeps the reference's
orientation quirk — global(text_i, video_j) + local(video_i, text_j),
summed elementwise, with local transposed only when the matrix is not
square (MSCOCO every-5th-row gallery dedup).

One departure, on bf16 models only: embeddings are returned as f32 (bf16
values upcast exactly, since numpy has no bf16) and the global cosine
sims are computed in f32, where the JAX path keeps them in bf16.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from demovlp_tpu_torch.device import to_device
from demovlp_tpu_torch.ops.masking import additive_mask
from demovlp_tpu_torch.ops.similarity import sim_matrix
from demovlp_tpu_torch.parallel.sharded_eval import sharded_local_sims
from demovlp_tpu_torch.train.steps import pad_batch, prepare_batch

#: keys of the gathered embedding dict, in trainer order
EMBED_KEYS = ("g_t", "g_o", "l_t", "l_o", "o_mask", "t_mask", "t_len")
OUT_KEYS = {
    "g_t": "global_text_embeddings",
    "g_o": "global_object_embeddings",
    "l_t": "local_text_embeddings",
    "l_o": "local_object_embeddings",
    "o_mask": "object_mask",
    "t_mask": "text_mask_add",
    "t_len": "text_length",
}


def make_embed_step(model: torch.nn.Module) -> Callable:
    """Forward-only embedding step: the model's five tensors plus the text
    mask (additive, CLS column dropped) and the text length."""

    @torch.inference_mode()
    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = dict(model(batch))
        out["text_mask_add"] = additive_mask(batch["attention_mask"][:, 1:])
        out["text_length"] = torch.sum(batch["attention_mask"], dim=1).to(torch.int32)
        return out

    return step


def embed_loader(embed_step: Callable, dl, tokenizer, device,
                 transfer_dtype: torch.dtype | None = None,
                 ) -> Tuple[Dict[str, np.ndarray], Dict[str, List[str]]]:
    """Embed every sample of the loader once -> (cat, metas).

    One batch is in flight: batch i's outputs are copied to pinned host
    memory behind its kernels and read only after batch i+1 has been
    assembled and launched, so host assembly and uploads overlap the
    card's work. `transfer_dtype` (bf16 for a bf16 model) casts the region
    tensor on the host before upload, halving its bytes; the tower's first
    op casts to the compute dtype anyway, so this is bit-identical."""
    device = torch.device(device)
    arrs: Dict[str, List[np.ndarray]] = {k: [] for k in EMBED_KEYS}
    paths: List[str] = []
    captions: List[str] = []

    def drain(host, done, keep) -> None:
        if done is not None:
            done.synchronize()
        for k in EMBED_KEYS:
            v = host[k]
            if v.dtype == torch.bfloat16:
                v = v.float()
            arrs[k].append(v.numpy()[keep])

    pending = None
    for data in dl:
        arrays, n_valid = pad_batch(prepare_batch(data, tokenizer), dl.batch_size)
        keep = np.arange(dl.batch_size) < n_valid
        for m in data["meta"]:
            paths.append(str(m["paths"]))
            captions.append(str(m["raw_captions"]))
        batch = {
            "input_ids": to_device(arrays["input_ids"].astype(np.int64), device),
            "attention_mask": to_device(arrays["attention_mask"].astype(np.int64), device),
            # host cast: round-to-nearest-even, as the tower's own cast does
            "object": to_device(arrays["object"], device, transfer_dtype),
            "object_mask": to_device(arrays["object_mask"], device),
        }
        out = embed_step(batch)
        if device.type == "cuda":
            host = {k: out[OUT_KEYS[k]].to("cpu", non_blocking=True) for k in EMBED_KEYS}
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = {k: out[OUT_KEYS[k]] for k in EMBED_KEYS}, None
        if pending is not None:
            drain(*pending)
        pending = (host, done, keep)
    if pending is not None:
        drain(*pending)
    cat = {k: np.concatenate(v, axis=0) for k, v in arrs.items()}
    return cat, {"paths": paths, "raw_captions": captions}


def load_index(path) -> Tuple[Dict[str, np.ndarray], Dict[str, List[str]]]:
    """Read back the npz that the extraction CLI writes."""
    with np.load(path, allow_pickle=False) as z:
        cat = {k: z[k] for k in EMBED_KEYS if k in z.files}
        meta = {k: [str(s) for s in z[k]] for k in ("paths", "raw_captions") if k in z.files}
    return cat, meta


def combined_sims(cat: Dict[str, np.ndarray], device, *, use_local: bool = True,
                  lambda_softmax: float = 20.0, focal_type: str = "prob",
                  mscoco_dedup: bool = False) -> np.ndarray:
    """(text, video) similarity matrix as the trainer scores eval: global
    cosine sims + (if use_local) the local cross-attention sims, summed
    with the reference's orientation quirk."""
    device = torch.device(device)
    if mscoco_dedup:
        cat = dict(cat)
        for key in ("g_o", "l_o", "o_mask"):
            cat[key] = cat[key][::5]
    g_t = torch.from_numpy(np.asarray(cat["g_t"], np.float32)).to(device)
    g_o = torch.from_numpy(np.asarray(cat["g_o"], np.float32)).to(device)
    sims = sim_matrix(g_t, g_o).cpu().numpy()
    if use_local:
        local = sharded_local_sims(
            cat["l_o"], cat["l_t"], cat["o_mask"], cat["t_mask"], device=device,
            lambda_softmax=lambda_softmax, focal_type=focal_type,
        )
        # (video, text); non-square only under MSCOCO dedup, where the
        # reference's elementwise quirk is undefined: transpose then
        if local.shape != sims.shape:
            local = local.T
        sims = sims + local
    return sims


def topk_retrieval(sims: np.ndarray, k: int = 10,
                   query_meta: Dict[str, List[str]] | None = None,
                   gallery_meta: Dict[str, List[str]] | None = None,
                   ) -> List[Dict[str, Any]]:
    """Per-query top-k gallery indices and scores from a (query, gallery)
    similarity matrix, with optional metadata attached."""
    k = min(k, sims.shape[1])
    order = np.argsort(-sims, axis=1)[:, :k]
    results = []
    for q, idxs in enumerate(order):
        entry: Dict[str, Any] = {
            "query_index": q,
            "topk_indices": idxs.tolist(),
            "topk_scores": sims[q, idxs].astype(float).tolist(),
        }
        if query_meta is not None:
            entry["query_caption"] = query_meta["raw_captions"][q]
        if gallery_meta is not None:
            entry["topk_paths"] = [gallery_meta["paths"][i] for i in idxs]
        results.append(entry)
    return results
