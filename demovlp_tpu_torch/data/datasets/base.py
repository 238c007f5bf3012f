"""Region dataset base (copy of demovlp_tpu/data/datasets/base.py).

Directories expand environment variables (reference base/base_dataset.py:
32-34). A video item reads its region directory: `{dir}/0.npz` must exist
and the directory must hold at least 2 frame files, or the item is swapped
for a random other one, at most `_MAX_RETRIES` times, each swap counted in
`resample_count` (the reference recurses without bound). Frames are sampled
at random in train and at interval midpoints otherwise, the last one
repeated when the video has fewer frames than `num_frames`, and decoded by
the native reader (data/native.py) or, where the caller asked for it with
DEMOVLP_NATIVE=0, by numpy (data/regions.py); a reader that cannot be
built raises. `plan_item` draws the same
generator values as `get_item` without decoding, so the loader can decode a
whole batch in one native call and give the same batch.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

import numpy as np

from demovlp_tpu_torch.data import native
from demovlp_tpu_torch.data.regions import (FEAT_DIM, GEOM_DIM, REGION_DIM, load_frame_regions,
                                            select_regions)
from demovlp_tpu_torch.data.sampling import sample_frame_indices

__all__ = ["RegionDataset", "FEAT_DIM", "GEOM_DIM", "REGION_DIM", "meta_data_dir"]

_MAX_RETRIES = 20


def meta_data_dir() -> str:
    """The shipped split metadata (reference: ./meta_data), or
    DEMOVLP_META_DIR."""
    return os.environ.get("DEMOVLP_META_DIR", "./meta_data")


class RegionDataset:
    def __init__(
        self,
        dataset_name: str,
        text_params: Optional[dict] = None,
        object_params: Optional[dict] = None,
        data_dir: str = "",
        object_dir: str = "",
        metadata_dir: Optional[str] = None,
        split: str = "train",
        tsfms=None,
        cut: Optional[str] = None,
        subsample: float = 1,
        sliding_window_stride: int = -1,
        reader: str = "cv2",
        seed: int = 0,
    ):
        self.dataset_name = dataset_name
        self.text_params = text_params or {}
        self.object_params = object_params or {}
        self.data_dir = os.path.expandvars(data_dir)
        self.object_dir = os.path.expandvars(object_dir)
        self.metadata_dir = (
            os.path.expandvars(metadata_dir) if metadata_dir is not None else self.data_dir
        )
        self.split = split
        self.transforms = tsfms
        self.cut = cut
        self.subsample = subsample
        self.sliding_window_stride = sliding_window_stride
        self.reader = reader
        self.segments = int(self.object_params.get("num_frames", 4))
        self.object_num = int(self.object_params.get("object_num", 20))
        self.seed = seed
        self.resample_count = 0
        self._count_lock = threading.Lock()  # loader threads resample at once
        self._text_lens_cache: Optional[np.ndarray] = None
        self._load_metadata()

    # ---- subclass hooks
    def _load_metadata(self):
        raise NotImplementedError

    def _num_samples(self) -> int:
        return len(self.metadata)

    def _object_path(self, index: int) -> str:
        """The item's region directory (or file)."""
        raise NotImplementedError

    def _text(self, index: int, rng: np.random.Generator):
        """Caption, question or options."""
        raise NotImplementedError

    def _extras(self, index: int) -> Dict[str, Any]:
        """Task fields (label, question_id, mc_id)."""
        return {}

    # ---- shared mechanics
    def __len__(self) -> int:
        return self._num_samples()

    def text_lengths(self) -> np.ndarray:
        """Whitespace word counts of each item's text (the longest option
        where the text is a list), drawn with `default_rng(0)`: the length
        proxy of length-grouped batching. Cached."""
        if self._text_lens_cache is None:
            rng = np.random.default_rng(0)
            lens = np.empty(len(self), dtype=np.int32)
            for i in range(len(self)):
                t = self._text(i, rng)
                if isinstance(t, (list, tuple)):
                    t = max((str(x) for x in t), key=len, default="")
                lens[i] = len(str(t).split())
            self._text_lens_cache = lens
        return self._text_lens_cache

    def _frame_indices(self, vlen: int, rng: np.random.Generator):
        if self.split == "train":
            idxs = sample_frame_indices(self.segments, vlen, "rand", rng)
        else:
            idxs = sample_frame_indices(self.segments, vlen, "uniform")
        while len(idxs) < self.segments:  # short video: repeat the last frame
            idxs.append(idxs[-1])
        return idxs

    def plan_paths(self, item: int, rng: np.random.Generator):
        """Frame npz paths for `item`, or None if it is unreadable (caller
        resamples). Draws from `rng` as `_load_objects` does."""
        object_fp = self._object_path(item)
        if not os.path.exists(os.path.join(object_fp, "0.npz")):
            return None
        vlen = len(os.listdir(object_fp))
        if vlen < 2:
            return None
        frame_idxs = self._frame_indices(vlen, rng)
        return [os.path.join(object_fp, f"{i}.npz") for i in frame_idxs]

    def _load_objects(self, index: int, rng: np.random.Generator):
        """(object, mask, lens), or None if the item is unreadable. A file
        the native reader cannot decode is read with numpy, as the JAX
        package reads it; where numpy fails too, the item is resampled."""
        reader = native.get_native_reader() if native.native_enabled() else None
        paths = self.plan_paths(index, rng)
        if paths is None:
            return None
        try:
            if reader is not None:
                try:
                    return reader.read_paths(paths, self.object_num)
                except OSError:
                    pass
            return select_regions([load_frame_regions(p) for p in paths], self.object_num)
        except Exception:  # an undecodable file: the caller resamples
            return None

    def __getitem__(self, item: int) -> Dict[str, Any]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, item & 0x7FFFFFFF]))
        return self.get_item(item, rng)

    def _resample(self, item: int, rng: np.random.Generator, attempt):
        """Call `attempt(item, rng)` until it is not None, swapping the item
        for a random other one each time it is; (item, result)."""
        item = item % len(self)
        for _ in range(_MAX_RETRIES):
            result = attempt(item, rng)
            if result is not None:
                return item, result
            with self._count_lock:
                self.resample_count += 1
            item = int(rng.integers(0, len(self)))
        raise RuntimeError(f"{self.dataset_name}: no readable sample after {_MAX_RETRIES} tries")

    def _fields(self, item: int, rng: np.random.Generator) -> Dict[str, Any]:
        text = self._text(item, rng)
        return {"text": text, "meta": self._meta(item, text), **self._extras(item)}

    def plan_item(self, item: int, rng: np.random.Generator):
        """(frame paths, non-object fields) as get_item draws them; the
        loader decodes the objects of a whole batch in one native call."""
        item, paths = self._resample(item, rng, self.plan_paths)
        return paths, self._fields(item, rng)

    def _meta(self, item: int, text) -> Dict[str, Any]:
        """The raw caption (the first option of a multiple-choice item),
        region path and dataset name."""
        raw_caption = text[0] if isinstance(text, (list, tuple)) and text else text
        return {
            "paths": self._object_path(item),
            "raw_captions": raw_caption,
            "dataset": self.dataset_name,
        }

    def get_item(self, item: int, rng: np.random.Generator) -> Dict[str, Any]:
        item, (obj, obj_mask, obj_len) = self._resample(item, rng, self._load_objects)
        return {"object": obj, "object_mask": obj_mask, "object_len": obj_len,
                **self._fields(item, rng)}
