"""Conceptual Captions 3M adapter, images as 1-frame videos (copy of
demovlp_tpu/data/datasets/cc3m.py; reference
data_loader/ConceptualCaptions_dataset.py).

Metadata: {meta_data}/cc3m_{training,validation}_success_full.tsv, headerless
"caption\\tid_hash". Regions: one npz an image at
{object_dir}/{split}/{zfill7(prefix)[:4]}/{name}_1.npz, else _0.npz. It
overrides `_load_objects`, so its batches take the per-sample path.
"""
from __future__ import annotations

import os

import numpy as np

from demovlp_tpu_torch.data.datasets.base import RegionDataset, meta_data_dir
from demovlp_tpu_torch.data.datasets.table import read_table, sample_rows
from demovlp_tpu_torch.data.regions import read_image_regions


class ConceptualCaptions3MObjectSelect(RegionDataset):
    def _load_metadata(self):
        split_files = {"train": "cc3m_training_success_full.tsv",
                       "val": "cc3m_validation_success_full.tsv"}
        rows = read_table(os.path.join(meta_data_dir(), split_files[self.split]),
                          names=["caption", "vid"])
        if self.subsample < 1:
            rows = sample_rows(rows, self.subsample)
        self.metadata = rows  # [caption, vid]

    def _object_path(self, index: int) -> str:
        name = self.metadata[index][1]
        pre = name.split("_")[0].zfill(7)
        return os.path.join(self.object_dir, self.split, pre[:4], name + "_1.npz")

    def _text(self, index: int, rng) -> str:
        return self.metadata[index][0]

    def _load_objects(self, index: int, rng: np.random.Generator):
        path = self._object_path(index)
        if not os.path.exists(path):
            path = path.replace("_1.npz", "_0.npz")
            if not os.path.exists(path):
                return None
        try:
            return read_image_regions(path, self.object_num)
        except Exception:  # an undecodable file: the caller resamples
            return None
