"""DiDeMo adapter (copy of demovlp_tpu/data/datasets/didemo.py; reference
data_loader/DiDeMo_dataset.py).

Metadata: {meta_data}/DiDeMo_{train,test}.tsv, headerless
"cap1, cap2, ...\\tvideo_file.mp4". Regions:
{object_dir}/{video_file minus extension}/{frame}.npz.
"""
from __future__ import annotations

import os

from demovlp_tpu_torch.data.datasets.base import RegionDataset, meta_data_dir
from demovlp_tpu_torch.data.datasets.table import read_table, sample_rows


class DiDeMoObjectSelect(RegionDataset):
    def _load_metadata(self):
        split_files = {"train": "DiDeMo_train.tsv", "val": "DiDeMo_test.tsv",
                       "test": "DiDeMo_test.tsv"}
        rows = read_table(os.path.join(meta_data_dir(), split_files[self.split]),
                          names=["caption", "vid"])
        if self.subsample < 1:
            rows = sample_rows(rows, self.subsample)
        self.metadata = rows  # [caption, vid]

    def _object_path(self, index: int) -> str:
        return os.path.join(self.object_dir, self.metadata[index][1].split(".")[0])

    def _text(self, index: int, rng) -> str:
        return self.metadata[index][0]
