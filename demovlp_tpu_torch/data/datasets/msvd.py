"""MSVD retrieval + QA adapters (copy of demovlp_tpu/data/datasets/msvd.py;
reference data_loader/MSVD_dataset.py).

Retrieval metadata: {meta_data}/MSVD_{train,test}.tsv, headerless
"cap1, cap2, ...\\tvideo_id"; the first comma-field is the caption.
QA: msvd_answer_set.txt (line index = label), msvd_youtube_mapping.txt
("youtube_id vidN"), msvd_{split}_qa_encode.json; answer_type = first
question word. Regions: {object_dir}/{video_id or youtube_id}/{frame}.npz.
"""
from __future__ import annotations

import os
import random
from typing import Any, Dict

from demovlp_tpu_torch.data.datasets.base import RegionDataset, meta_data_dir
from demovlp_tpu_torch.data.datasets.table import read_table, sample_rows
from demovlp_tpu_torch.utils.io import load_json


class MSVDObjectSelect(RegionDataset):
    def _load_metadata(self):
        split_files = {"train": "MSVD_train.tsv", "val": "MSVD_test.tsv", "test": "MSVD_test.tsv"}
        rows = read_table(os.path.join(meta_data_dir(), split_files[self.split]),
                          names=["caption", "vid"])
        if self.subsample < 1:
            rows = sample_rows(rows, self.subsample)
        self.metadata = rows  # [caption, vid]

    def _object_path(self, index: int) -> str:
        return os.path.join(self.object_dir, self.metadata[index][1])

    def _text(self, index: int, rng) -> str:
        # first of the comma-joined captions (reference MSVD_dataset.py:54-55)
        return self.metadata[index][0].split(",")[0]


class MSVDQAObjectSelect(RegionDataset):
    def _load_metadata(self):
        meta_dir = meta_data_dir()
        self.ans2label = {}
        with open(os.path.join(meta_dir, "msvd_answer_set.txt")) as f:
            for idx, label in enumerate(f.readlines()):
                self.ans2label[label.strip()] = idx
        self.vid2link = {}
        with open(os.path.join(meta_dir, "msvd_youtube_mapping.txt")) as f:
            for line in f.readlines():
                link, vid = line.strip().split(" ")
                self.vid2link[int(vid[3:])] = link
        split_files = {"train": "msvd_train_qa_encode.json", "test": "msvd_test_qa_encode.json",
                       "val": "msvd_val_qa_encode.json"}
        raw = load_json(os.path.join(meta_dir, split_files[self.split]))
        if self.subsample < 1:
            n = int(len(raw) * self.subsample)
            random.shuffle(raw)
            raw = raw[:n]
        self.metadata = [
            dict(question=d["question"], vid_id=d["video_id"], answer=d["answer"],
                 question_id=d["id"], answer_type=d["question"].split(" ")[0])
            for d in raw
        ]
        self.num_labels = len(self.ans2label)
        self.label2ans = {v: k for k, v in self.ans2label.items()}
        self.qid2data = {d["question_id"]: d for d in self.metadata}

    def _object_path(self, index: int) -> str:
        return os.path.join(self.object_dir, self.vid2link[self.metadata[index]["vid_id"]])

    def _text(self, index: int, rng) -> str:
        return self.metadata[index]["question"]

    def _extras(self, index: int) -> Dict[str, Any]:
        d = self.metadata[index]
        label = self.ans2label[d["answer"]] if self.split == "train" else -1
        return {"label": label, "question_id": d["question_id"]}
