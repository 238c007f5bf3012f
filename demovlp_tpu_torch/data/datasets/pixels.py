"""Seeded synthetic clips of raw frames, for pixel models (FrozenInTime).

No video or frame archive ships with the repository, so a pixel model
trains on clips drawn from the seed: a pool of `pool` uint8 clips
(F, 3, R, R) is drawn once, when the dataset is built, and sample i is
clip i % pool of it, so serving a sample costs a slice and no draws on the
loader's threads. Captions are 3-9 words, drawn per index as the synthetic
region dataset draws them.

`video_params` (Frozen's data-loader keys): `num_frames` (4), `input_res`
(224), `num_samples` (train split, 64), `eval_samples` (other splits,
1000: MSR-VTT's 1k-A test), `pool` (256 clips, drawn from seed 0).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from demovlp_tpu_torch.data.datasets.synthetic import _WORDS


class SyntheticPixels:
    def __init__(self, dataset_name: str, text_params: Optional[dict] = None,
                 video_params: Optional[dict] = None, split: str = "train", **_region_keys):
        vp = dict(video_params or {})
        self.dataset_name = dataset_name
        self.text_params = text_params or {}
        self.split = split
        self.num_frames = int(vp.get("num_frames", 4))
        self.resolution = int(vp.get("input_res", 224))
        self.num_samples = int(vp.get("num_samples", 64) if split == "train"
                               else vp.get("eval_samples", 1000))
        pool = min(int(vp.get("pool", 256)), self.num_samples)
        gen = np.random.default_rng(0)
        self.pool = gen.integers(0, 256, (pool, self.num_frames, 3, self.resolution,
                                          self.resolution), dtype=np.uint8)
        self._text_lens: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return self.num_samples

    def _caption(self, index: int) -> str:
        rng = np.random.default_rng(1000 + index * 37)
        n = int(rng.integers(3, 10))
        return " ".join(_WORDS[int(w)] for w in rng.integers(0, len(_WORDS), n))

    def text_lengths(self) -> np.ndarray:
        """Word counts of each caption (the loader's length proxy)."""
        if self._text_lens is None:
            self._text_lens = np.array([len(self._caption(i).split()) for i in range(len(self))],
                                       dtype=np.int32)
        return self._text_lens

    def get_item(self, index: int, rng=None) -> Dict[str, Any]:
        text = self._caption(index)
        return {"video": self.pool[index % len(self.pool)], "text": text,
                "meta": {"paths": f"synthetic-pixels://{index}", "raw_captions": text,
                         "dataset": self.dataset_name}}
