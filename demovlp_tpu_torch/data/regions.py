"""The npz region-feature pipeline (copy of demovlp_tpu/data/regions.py;
bit-identical results).

  per frame npz: {x: (N, 2048) features, bbox: (N, 4) xyxy pixels,
                  info: {objects_conf, objects_id, image_w, image_h}}
  1. sort regions by detector confidence, descending (argsort reversed, so
     ties order as the reference orders them)
  2. 6-d normalized geometry: (x1/W, y1/H, x1/W + w/W, y1/H + h/H, w/W, h/H),
     kept in this compositional form for bit parity
  3. keep top-K regions; if fewer than K, edge-pad (repeat the last row)
  4. validity mask marks the true (pre-pad) count per frame
  5. concat features(2048) + geometry(6) -> (F, K, 2054) float32
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

FEAT_DIM = 2048  # appearance features per region
GEOM_DIM = 6  # normalised box geometry
REGION_DIM = FEAT_DIM + GEOM_DIM


def _geometry(boxes: np.ndarray, image_w: float, image_h: float) -> np.ndarray:
    """(N,4) pixel xyxy boxes -> (N,6) normalized geometry."""
    box_w = boxes[:, 2] - boxes[:, 0]
    box_h = boxes[:, 3] - boxes[:, 1]
    sw = box_w / image_w
    sh = box_h / image_h
    sx = boxes[:, 0] / image_w
    sy = boxes[:, 1] / image_h
    return np.stack([sx, sy, sx + sw, sy + sh, sw, sh], axis=1)


def load_frame_regions(npz_file) -> Dict[str, np.ndarray]:
    """One frame's npz as confidence-sorted arrays:
    {feat (N,2048), conf (N,), ids (N,), geometry (N,6)}."""
    frame = np.load(npz_file, allow_pickle=True)
    features = frame["x"]
    boxes = frame["bbox"]
    info = frame["info"].item()
    conf = info["objects_conf"]
    ids = info["objects_id"]
    order = np.argsort(conf)[::-1]
    return {
        "feat": features[order],
        "conf": conf[order],
        "ids": ids[order],
        "geometry": _geometry(boxes[order], info["image_w"], info["image_h"]),
    }


def select_regions(frames: Sequence[Dict[str, np.ndarray]], object_num: int):
    """Top-K select + edge-pad each frame's regions to exactly `object_num`.
    Returns (object (F, K, 2054) float32, mask (F, K) float32, lens list)."""
    f = len(frames)
    out = np.zeros((f, object_num, REGION_DIM), dtype=np.float32)
    mask = np.zeros((f, object_num), dtype=np.float32)
    lens: List[int] = []
    for i, fr in enumerate(frames):
        feat, geom = fr["feat"], fr["geometry"]
        n = min(len(feat), object_num)
        lens.append(n)
        out[i, :n, :FEAT_DIM] = feat[:n]
        out[i, :n, FEAT_DIM:] = geom[:n]
        if n < object_num:  # edge-pad: repeat the last valid region
            out[i, n:, :FEAT_DIM] = feat[n - 1]
            out[i, n:, FEAT_DIM:] = geom[n - 1]
        mask[i, :n] = 1.0
    return out, mask, lens


def read_video_regions(object_dir: str, frame_idxs: Sequence[int], object_num: int):
    """`{i}.npz` for each sampled frame index of a per-video directory,
    through the selection pipeline."""
    frames = [load_frame_regions(os.path.join(object_dir, f"{idx}.npz")) for idx in frame_idxs]
    return select_regions(frames, object_num)


def read_image_regions(npz_path: str, object_num: int):
    """One npz as a 1-frame video (CC3M's images)."""
    return select_regions([load_frame_regions(npz_path)], object_num)


def read_object_topk(object_dir: str, frame_idxs: Sequence[int], top_k: int = 20,
                     unique_classes: bool = False) -> np.ndarray:
    """Maskless top-k reader (reference base/base_dataset.py:138-204): per
    frame, confidence-sorted regions, optionally deduped by detector class,
    edge-padded then cut to top_k; an unreadable frame is an all-ones block.
    Returns (F, top_k, 2054)."""
    out = np.ones((len(frame_idxs), top_k, REGION_DIM), dtype=np.float32)
    for i, idx in enumerate(frame_idxs):
        try:
            fr = load_frame_regions(os.path.join(object_dir, f"{idx}.npz"))
        except OSError:
            continue
        feat, geom, ids = fr["feat"], fr["geometry"], fr["ids"]
        if unique_classes:
            _, uniq = np.unique(ids, return_index=True)
            feat, geom = feat[uniq], geom[uniq]
        n = feat.shape[0]
        if n < top_k:
            feat = np.pad(feat, ((0, top_k - n), (0, 0)), "edge")
            geom = np.pad(geom, ((0, top_k - n), (0, 0)), "edge")
        out[i, :, :FEAT_DIM] = feat[:top_k]
        out[i, :, FEAT_DIM:] = geom[:top_k]
    return out
