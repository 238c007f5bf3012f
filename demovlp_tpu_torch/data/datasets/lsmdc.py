"""LSMDC retrieval + multiple-choice adapters (copy of
demovlp_tpu/data/datasets/lsmdc.py; reference data_loader/LSMDC_dataset.py).

Metadata lives inside data_dir ({data_dir}/meta_data/LSMDC16_*.csv,
tab-separated). Clip paths come from clip names: "Movie_XYZ_clipid" ->
"Movie_XYZ/" + the full clip name. MC: options are columns 5..9; the answer
column is 1-indexed (-> -1) on val/test, 0 on train.
"""
from __future__ import annotations

import os
from typing import Any, Dict

from demovlp_tpu_torch.data.datasets.base import RegionDataset
from demovlp_tpu_torch.data.datasets.table import read_table, sample_rows


def _movie_rel_path(video_fp: str) -> str:
    sub_path = video_fp.split(".")[0]
    tail = sub_path.split("_")[-1]
    movie_dir = sub_path.replace("_" + tail, "/")
    return movie_dir + video_fp


class LSMDCObjectSelect(RegionDataset):
    def _load_metadata(self):
        split_files = {"train": "LSMDC16_annos_training.csv",
                       "val": "LSMDC16_challenge_1000_publictect.csv",
                       "test": "LSMDC16_challenge_1000_publictect.csv"}
        rows = read_table(os.path.join(self.data_dir, "meta_data", split_files[self.split]))
        if self.subsample < 1:
            rows = sample_rows(rows, self.subsample)
        self.metadata = rows

    def _object_path(self, index: int) -> str:
        return os.path.join(self.object_dir, _movie_rel_path(self.metadata[index][0]))

    def _text(self, index: int, rng) -> str:
        return self.metadata[index][-1]


class LSMDCMCObjectSelect(RegionDataset):
    def _load_metadata(self):
        split_files = {"train": "LSMDC16_multiple_choice_train.csv",
                       "val": "LSMDC16_multiple_choice_test_randomized.csv",
                       "test": "LSMDC16_multiple_choice_test_randomized.csv"}
        rows = read_table(os.path.join(self.data_dir, "meta_data", split_files[self.split]))
        if self.subsample < 1:
            rows = sample_rows(rows, self.subsample)
        self.metadata = [
            dict(id=row[0], vid_id=_movie_rel_path(row[0]) + ".avi",
                 answer=int(row[-1]) - 1 if self.split in ("val", "test") else 0,
                 options=[row[i] for i in range(5, 10)])
            for row in rows
        ]
        self.id2answer = {d["id"]: int(d["answer"]) for d in self.metadata}
        self.id2data = {d["id"]: d for d in self.metadata}

    def _object_path(self, index: int) -> str:
        return os.path.join(self.object_dir, _movie_rel_path(self.metadata[index]["id"]))

    def _text(self, index: int, rng):
        return self.metadata[index]["options"]

    def _extras(self, index: int) -> Dict[str, Any]:
        d = self.metadata[index]
        return {"label": d["answer"], "mc_id": d["id"]}
