"""Image/video transform dictionary (copy of demovlp_tpu/data/transforms.py),
for API parity: the reference builds torchvision pipelines per split
(data_loader/transforms.py:5-63) which the region-feature datasets construct
but never apply. The same surface with light numpy callables, so configs
round-trip; the region path never calls them.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def _normalize(img: np.ndarray) -> np.ndarray:
    return (img.astype(np.float32) / 255.0 - _IMAGENET_MEAN) / _IMAGENET_STD


def _center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    top = max(0, (h - size) // 2)
    left = max(0, (w - size) // 2)
    return img[top : top + size, left : left + size]


def _resize_shorter(img: np.ndarray, size: int) -> np.ndarray:
    # nearest-neighbor resize (no cv2 dependency); adequate for the unused path
    h, w = img.shape[:2]
    scale = size / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    ys = (np.arange(nh) * (h / nh)).astype(int).clip(0, h - 1)
    xs = (np.arange(nw) * (w / nw)).astype(int).clip(0, w - 1)
    return img[ys][:, xs]


def _eval_pipeline(input_res: int) -> Callable:
    def fn(img: np.ndarray) -> np.ndarray:
        return _normalize(_center_crop(_resize_shorter(img, input_res), input_res))

    return fn


def _train_pipeline(input_res: int, rng: np.random.Generator | None = None) -> Callable:
    gen = rng or np.random.default_rng()

    def fn(img: np.ndarray) -> np.ndarray:
        img = _resize_shorter(img, input_res)
        h, w = img.shape[:2]
        top = int(gen.integers(0, max(1, h - input_res + 1)))
        left = int(gen.integers(0, max(1, w - input_res + 1)))
        img = img[top : top + input_res, left : left + input_res]
        if gen.random() < 0.5:
            img = img[:, ::-1]
        return _normalize(img)

    return fn


def init_transform_dict(
    input_res: int = 224,
    center_crop: int = 256,
    randcrop_scale=(0.5, 1.0),
    color_jitter=(0, 0, 0),
    norm_mean=(0.485, 0.456, 0.406),
    norm_std=(0.229, 0.224, 0.225),
    **_,
) -> Dict[str, Callable]:
    return {
        "train": _train_pipeline(input_res),
        "val": _eval_pipeline(input_res),
        "test": _eval_pipeline(input_res),
    }


def init_video_transform_dict(**kwargs) -> Dict[str, Callable]:
    return init_transform_dict(**kwargs)
