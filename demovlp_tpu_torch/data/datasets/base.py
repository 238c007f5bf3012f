"""Region dataset base (cut-down copy of demovlp_tpu/data/datasets/base.py:
the `get_item`/`_meta` mechanics the synthetic serving path calls). The
npz/native region reader, frame sampling and the resampling of unreadable
samples wait for a later slice."""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

FEAT_DIM = 2048  # appearance features per region
GEOM_DIM = 6  # normalised box geometry
REGION_DIM = FEAT_DIM + GEOM_DIM


class RegionDataset:
    def __init__(self, dataset_name: str, text_params: Optional[dict] = None,
                 object_params: Optional[dict] = None, split: str = "train",
                 seed: int = 0, **_unused):
        self.dataset_name = dataset_name
        self.text_params = text_params or {}
        self.object_params = object_params or {}
        self.split = split
        self.segments = int(self.object_params.get("num_frames", 4))
        self.object_num = int(self.object_params.get("object_num", 20))
        self.seed = seed
        self._load_metadata()

    def _load_metadata(self):
        raise NotImplementedError

    def _object_path(self, index: int) -> str:
        raise NotImplementedError

    def _load_objects(self, index: int, rng: np.random.Generator):
        """(object (F,K,2054), mask (F,K), lens)."""
        raise NotImplementedError

    def _text(self, index: int, rng: np.random.Generator):
        raise NotImplementedError

    def _extras(self, index: int) -> Dict[str, Any]:
        """Task fields (label, question_id, mc_id)."""
        return {}

    def __len__(self) -> int:
        return len(self.metadata)

    def __getitem__(self, item: int) -> Dict[str, Any]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, item & 0x7FFFFFFF]))
        return self.get_item(item, rng)

    def _meta(self, item: int, text) -> Dict[str, Any]:
        raw_caption = text[0] if isinstance(text, (list, tuple)) and text else text
        return {
            "paths": self._object_path(item),
            "raw_captions": raw_caption,
            "dataset": self.dataset_name,
        }

    def get_item(self, item: int, rng: np.random.Generator) -> Dict[str, Any]:
        item = item % len(self)
        obj, obj_mask, obj_len = self._load_objects(item, rng)
        text = self._text(item, rng)
        return {
            "object": obj,
            "object_mask": obj_mask,
            "object_len": obj_len,
            "text": text,
            "meta": self._meta(item, text),
            **self._extras(item),
        }
