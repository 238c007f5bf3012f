"""Synthetic region dataset (copy of demovlp_tpu/data/datasets/synthetic.py,
retrieval task). Each index yields a stable pseudo-random sample, bit-
identical to the JAX package's for the same index and settings."""
from __future__ import annotations

import numpy as np

from demovlp_tpu_torch.data.datasets.base import FEAT_DIM, REGION_DIM, RegionDataset

_WORDS = (
    "a the person dog cat car runs jumps plays red blue small large street park "
    "video shows man woman child ball game water tree house music group walking"
).split()


class SyntheticObjectSelect(RegionDataset):
    """object_params may set `num_samples` (default 64), `caption_style`
    ("short": 3-9 words; "long_tail": lognormal, ~12-word median) and
    `task`; only "retrieval" is ported."""

    def _load_metadata(self):
        self.num_samples = int(self.object_params.get("num_samples", 64))
        self.task = self.object_params.get("task", "retrieval")
        if self.task != "retrieval":
            raise NotImplementedError(
                f"synthetic task {self.task!r}: only 'retrieval' is ported"
            )
        self.caption_style = self.object_params.get("caption_style", "short")
        self.metadata = list(range(self.num_samples))

    def _caption(self, index: int, offset: int = 0) -> str:
        rng = np.random.default_rng(1000 + index * 37 + offset)
        if self.caption_style == "long_tail":
            n = int(min(3 + rng.lognormal(mean=np.log(9.0), sigma=0.55), 70))
        else:
            n = int(rng.integers(3, 10))
        return " ".join(_WORDS[int(w)] for w in rng.integers(0, len(_WORDS), n))

    def _object_path(self, index: int) -> str:
        return f"synthetic://{index}"

    def _load_objects(self, index: int, rng: np.random.Generator):
        gen = np.random.default_rng(index)
        f, k = self.segments, self.object_num
        obj = gen.standard_normal((f, k, REGION_DIM)).astype(np.float32)
        obj[..., FEAT_DIM:] = gen.uniform(0, 1, (f, k, REGION_DIM - FEAT_DIM))
        lens = gen.integers(1, k + 1, size=f)
        mask = (np.arange(k)[None, :] < lens[:, None]).astype(np.float32)
        return obj, mask, lens.tolist()

    def _text(self, index: int, rng) -> str:
        return self._caption(index)
