"""Offline embedding extraction, the retrieval index, free-text queries and
video-QA prediction on one card (counterpart of demovlp_tpu/serve.py:
`make_embed_step`, `embed_loader`, `make_text_embed_step`, `embed_texts`,
`load_index`, `query_retrieval`, `combined_sims`, `predict_qa`,
`topk_retrieval`).

Semantics follow the JAX serving path: the same embedding dict, pad rows
of the last batch dropped, and the combined matrix keeps the reference's
orientation quirk — global(text_i, video_j) + local(video_i, text_j),
summed elementwise, with local transposed only when the matrix is not
square (MSCOCO every-5th-row gallery dedup). A query matrix is never
square in that sense: its local sims are computed (gallery video, query
text) and transposed onto (query, gallery) (PARITY.md #16).

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
from demovlp_tpu_torch.train.steps import batch_to_device, pad_batch, prepare_batch

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
        model.eval()
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
            arrs[k].append(_host_rows(host[k], keep))

    pending = None
    for data in dl:
        arrays, n_valid = pad_batch(prepare_batch(data, tokenizer), dl.batch_size)
        keep = np.arange(dl.batch_size) < n_valid
        for m in data["meta"]:
            paths.append(str(m["paths"]))
            captions.append(str(m["raw_captions"]))
        # host cast of the regions: round-to-nearest-even, as the tower's own cast does
        out = embed_step(batch_to_device(arrays, device, transfer_dtype))
        host = _to_host({k: out[OUT_KEYS[k]] for k in EMBED_KEYS}, device)
        if pending is not None:
            drain(*pending)
        pending = (*host, keep)
    if pending is not None:
        drain(*pending)
    cat = {k: np.concatenate(v, axis=0) for k, v in arrs.items()}
    return cat, {"paths": paths, "raw_captions": captions}


def _to_host(out: Dict[str, torch.Tensor], device: torch.device):
    """(host tensors, event) for a step's outputs: on the card, copies into
    host memory queued behind the step's kernels and an event that marks
    them done; on the CPU, the tensors themselves and None."""
    if device.type != "cuda":
        return out, None
    host = {k: v.to("cpu", non_blocking=True) for k, v in out.items()}
    done = torch.cuda.Event()
    done.record()
    return host, done


def _host_rows(v: torch.Tensor, keep: np.ndarray) -> np.ndarray:
    """A host tensor's kept rows as numpy (bf16 upcast to f32 exactly)."""
    if v.dtype == torch.bfloat16:
        v = v.float()
    return v.numpy()[keep]


def make_text_embed_step(model: torch.nn.Module) -> Callable:
    """Text-tower-only forward for free-text queries: step(input_ids,
    attention_mask) -> {g_t, l_t, t_mask (additive, CLS column dropped)}."""

    @torch.inference_mode()
    def step(input_ids: torch.Tensor, attention_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        model.eval()
        g_t, l_t = model.compute_text(input_ids, attention_mask)
        return {"g_t": g_t, "l_t": l_t, "t_mask": additive_mask(attention_mask[:, 1:])}

    return step


def embed_texts(text_step: Callable, queries, tokenizer, device, *, batch_size: int = 128,
                max_text_len: int = 100) -> Dict[str, np.ndarray]:
    """Embed query strings through the text tower only, in batches of
    min(batch_size, len(queries)) rows, the last padded with "" rows that
    are dropped; one batch in flight, as in embed_loader. Returns {g_t
    (N, D), l_t (N, L-1, D), t_mask additive (N, L-1)} as f32 numpy."""
    if not queries:
        raise ValueError("embed_texts: empty query list")
    device = torch.device(device)
    queries = [str(q) for q in queries]
    bs = max(1, min(batch_size, len(queries)))
    outs: Dict[str, List[np.ndarray]] = {k: [] for k in ("g_t", "l_t", "t_mask")}

    def drain(host, done, keep) -> None:
        if done is not None:
            done.synchronize()
        for k in outs:
            outs[k].append(_host_rows(host[k], keep))

    pending = None
    for s in range(0, len(queries), bs):
        chunk = queries[s:s + bs]
        keep = np.arange(bs) < len(chunk)
        enc = tokenizer(chunk + [""] * (bs - len(chunk)), max_length=max_text_len)
        out = text_step(to_device(enc["input_ids"].astype(np.int64), device),
                        to_device(enc["attention_mask"].astype(np.int64), device))
        host = _to_host(out, device)
        if pending is not None:
            drain(*pending)
        pending = (*host, keep)
    drain(*pending)
    return {k: np.concatenate(v, axis=0) for k, v in outs.items()}


def load_index(path) -> Tuple[Dict[str, np.ndarray], Dict[str, List[str]]]:
    """Read back the npz that the extraction CLI writes."""
    with np.load(path, allow_pickle=False) as z:
        cat = {k: z[k] for k in EMBED_KEYS if k in z.files}
        meta = {k: [str(s) for s in z[k]] for k in ("paths", "raw_captions") if k in z.files}
    return cat, meta


def query_sims(q: Dict[str, np.ndarray], gallery: Dict[str, np.ndarray], device, *,
               use_local: bool = True, lambda_softmax: float = 20.0,
               focal_type: str = "prob") -> np.ndarray:
    """(query, gallery) sims: global cosine in f32, plus (if use_local) the
    local sims computed (gallery video, query text) and transposed."""
    device = torch.device(device)
    g_t = torch.from_numpy(np.asarray(q["g_t"], np.float32)).to(device)
    g_o = torch.from_numpy(np.asarray(gallery["g_o"], np.float32)).to(device)
    sims = sim_matrix(g_t, g_o).cpu().numpy()
    if use_local:
        local = sharded_local_sims(gallery["l_o"], q["l_t"], gallery["o_mask"], q["t_mask"],
                                   device=device, lambda_softmax=lambda_softmax,
                                   focal_type=focal_type)
        sims = sims + local.T
    return sims


def query_retrieval(text_step: Callable, queries, tokenizer, gallery: Dict[str, np.ndarray],
                    device, *, k: int = 10, use_local: bool = True,
                    lambda_softmax: float = 20.0, focal_type: str = "prob",
                    mscoco_dedup: bool = False,
                    gallery_meta: Dict[str, List[str]] | None = None,
                    batch_size: int = 128) -> Tuple[List[Dict[str, Any]], np.ndarray]:
    """Free-text queries -> top-k gallery videos against an index (the dict
    embed_loader returns or load_index reads; only g_o, l_o and o_mask are
    read). Under mscoco_dedup the gallery keeps every 5th row and the
    returned indices are npz rows (x 5). Returns (results, the (query,
    gallery) sims scored)."""
    q = embed_texts(text_step, queries, tokenizer, device, batch_size=batch_size)
    gal = gallery
    if mscoco_dedup:
        gal = {key: v[::5] for key, v in gallery.items()}
        if gallery_meta is not None:
            gallery_meta = {key: v[::5] for key, v in gallery_meta.items()}
    sims = query_sims(q, gal, device, use_local=use_local, lambda_softmax=lambda_softmax,
                      focal_type=focal_type)
    results = topk_retrieval(sims, k=k, query_meta={"raw_captions": [str(s) for s in queries]},
                             gallery_meta=gallery_meta)
    if mscoco_dedup:
        for r in results:
            r["topk_indices"] = [5 * i for i in r["topk_indices"]]
    return results, sims


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


def predict_qa(eval_step: Callable, dl, tokenizer, device, label2ans=None,
               transfer_dtype: torch.dtype | None = None) -> List[Dict[str, Any]]:
    """Video-QA prediction over a loader: one {question_id, answer (label
    index), answer_text (with label2ans)} a sample, every sample once, pad
    rows of the last batch dropped. `eval_step` is
    train.steps.make_qa_eval_step; one batch in flight and the host cast of
    the region tensor as in embed_loader."""
    device = torch.device(device)
    preds: List[np.ndarray] = []
    qids: List[np.ndarray] = []

    def drain(host, done, keep, batch_qids) -> None:
        if done is not None:
            done.synchronize()
        preds.append(host["pred"].numpy()[keep])
        qids.append(batch_qids)

    pending = None
    for data in dl:
        arrays = prepare_batch(data, tokenizer)
        arrays.pop("label", None)
        arrays, n_valid = pad_batch(arrays, dl.batch_size)
        keep = np.arange(dl.batch_size) < n_valid
        logits = eval_step(batch_to_device(arrays, device, transfer_dtype))
        host = _to_host({"pred": torch.argmax(logits, dim=-1)}, device)
        if pending is not None:
            drain(*pending)
        pending = (*host, keep, np.asarray(data["question_id"]))
    if pending is not None:
        drain(*pending)
    results: List[Dict[str, Any]] = []
    for qid, pred in zip(np.concatenate(qids) if qids else [],
                         np.concatenate(preds) if preds else []):
        entry: Dict[str, Any] = {"question_id": int(qid), "answer": int(pred)}
        if label2ans is not None:
            entry["answer_text"] = label2ans[int(pred)]
        results.append(entry)
    return results


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
