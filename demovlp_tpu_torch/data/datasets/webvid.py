"""WebVid adapter (copy of demovlp_tpu/data/datasets/webvid.py; reference
data_loader/WebVid_dataset.py).

Metadata: {meta_data}/webvid_{training,validation}_success_full.tsv,
headerless rows "caption\\tpage_dir/videoid", read headerless (the
reference reads a header row and so drops the first line). Regions:
{object_dir}/{split}/{page_dir}/{videoid}/{frame}.npz.
"""
from __future__ import annotations

import os

import numpy as np

from demovlp_tpu_torch.data.datasets.base import RegionDataset, meta_data_dir
from demovlp_tpu_torch.data.datasets.table import read_table, sample_rows
from demovlp_tpu_torch.data.sampling import sample_frame_indices


class WebVidObjectSelect(RegionDataset):
    def _load_metadata(self):
        split_files = {"train": "webvid_training_success_full.tsv",
                       "val": "webvid_validation_success_full.tsv",
                       "test": "webvid_validation_success_full.tsv"}
        rows = read_table(os.path.join(meta_data_dir(), split_files[self.split]),
                          names=["caption", "vid"])
        if self.subsample < 1:
            rows = sample_rows(rows, self.subsample)
        self.metadata = rows  # [caption, vid]

    def _object_path(self, index: int) -> str:
        return os.path.join(self.object_dir, self.split, self.metadata[index][1])

    def _text(self, index: int, rng) -> str:
        return self.metadata[index][0]

    def _frame_indices(self, vlen: int, rng: np.random.Generator):
        # exactly as many stored frames as segments: take them all
        # (reference WebVid_dataset.py:95-110)
        if self.segments == vlen:
            return list(range(self.segments))
        if self.split == "train":
            return sample_frame_indices(self.segments, vlen, "rand", rng)
        return sample_frame_indices(self.segments, vlen, "uniform")
