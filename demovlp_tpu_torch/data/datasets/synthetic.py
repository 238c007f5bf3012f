"""Synthetic region dataset (copy of demovlp_tpu/data/datasets/synthetic.py:
the retrieval, qa and mc tasks). Each index yields a stable pseudo-random
sample, bit-identical to the JAX package's for the same index and
settings."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from demovlp_tpu_torch.data.datasets.base import FEAT_DIM, REGION_DIM, RegionDataset

_WORDS = (
    "a the person dog cat car runs jumps plays red blue small large street park "
    "video shows man woman child ball game water tree house music group walking"
).split()


class SyntheticObjectSelect(RegionDataset):
    """object_params may set `num_samples` (default 64), `caption_style`
    ("short": 3-9 words; "long_tail": lognormal, ~12-word median), `task`
    in {retrieval, qa, mc}, `num_label` (qa) and `num_options` (mc)."""

    def _load_metadata(self):
        self.num_samples = int(self.object_params.get("num_samples", 64))
        self.task = self.object_params.get("task", "retrieval")
        if self.task not in ("retrieval", "qa", "mc"):
            raise ValueError(f"synthetic task {self.task!r}: expected retrieval, qa or mc")
        self.caption_style = self.object_params.get("caption_style", "short")
        self.num_label = int(self.object_params.get("num_label", 16))
        self.num_options = int(self.object_params.get("num_options", 5))
        self.metadata = list(range(self.num_samples))
        if self.task == "qa":
            self.label2ans = {i: f"ans{i}" for i in range(self.num_label)}
            self.ans2label = {v: k for k, v in self.label2ans.items()}
            self.qid2data = {
                i: {"answer": f"ans{self._label(i)}", "answer_type": "what", "question_id": i}
                for i in range(self.num_samples)
            }
        if self.task == "mc":
            self.id2answer = {i: self._label(i) % self.num_options
                              for i in range(self.num_samples)}
            self.id2data = {i: {"id": i} for i in range(self.num_samples)}

    def _label(self, index: int) -> int:
        return index % self.num_label

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

    def _text(self, index: int, rng):
        if self.task == "mc":
            return [self._caption(index, o) for o in range(self.num_options)]
        return self._caption(index)

    def _extras(self, index: int) -> Dict[str, Any]:
        if self.task == "qa":
            return {"label": self._label(index), "question_id": index}
        if self.task == "mc":
            return {"label": self._label(index) % self.num_options, "mc_id": index}
        return {}
