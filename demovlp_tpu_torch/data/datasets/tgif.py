"""TGIF-FrameQA adapter (copy of demovlp_tpu/data/datasets/tgif.py;
reference data_loader/TGIF_dataset.py).

Metadata: {meta_data}/frameqa_{split}.jsonl + frameqa_trainval_ans2label.json.
Regions: {object_dir}/{gif_name}/{frame}.npz.
"""
from __future__ import annotations

import os
import random
from typing import Any, Dict

from demovlp_tpu_torch.data.datasets.base import RegionDataset, meta_data_dir
from demovlp_tpu_torch.utils.io import load_json, load_jsonl


class TGIFFrameObjectSelect(RegionDataset):
    def _load_metadata(self):
        meta_dir = meta_data_dir()
        self.ans2label = load_json(os.path.join(meta_dir, "frameqa_trainval_ans2label.json"))
        split_files = {"train": "frameqa_train.jsonl", "val": "frameqa_val.jsonl",
                       "test": "frameqa_test.jsonl"}
        raw = load_jsonl(os.path.join(meta_dir, split_files[self.split]))
        if self.subsample < 1:
            n = int(len(raw) * self.subsample)
            random.shuffle(raw)
            raw = raw[:n]
        self.metadata = [
            dict(question=d["question"], vid_id=d["gif_name"], answer=d["answer"],
                 question_id=qid, answer_type=d["answer_type"])
            for qid, d in enumerate(raw)
        ]
        self.num_labels = len(self.ans2label)
        self.label2ans = {v: k for k, v in self.ans2label.items()}
        self.qid2data = {d["question_id"]: d for d in self.metadata}

    def _object_path(self, index: int) -> str:
        return os.path.join(self.object_dir, self.metadata[index]["vid_id"])

    def _text(self, index: int, rng) -> str:
        return self.metadata[index]["question"]

    def _extras(self, index: int) -> Dict[str, Any]:
        d = self.metadata[index]
        label = self.ans2label[d["answer"]] if self.split == "train" else -1
        return {"label": label, "question_id": d["question_id"]}
