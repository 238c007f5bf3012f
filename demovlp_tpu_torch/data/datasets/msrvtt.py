"""MSRVTT retrieval / QA / MC adapters (copy of
demovlp_tpu/data/datasets/msrvtt.py; reference data_loader/MSRVTT_dataset.py).

Metadata:
  retrieval: {metadata_dir}/annotation/MSR_VTT.json +
             {metadata_dir}/high-quality/structured-symlinks/<cut lists>
  QA:        {meta_data}/msrvtt_qa_{split}.jsonl + msrvtt_train_ans2label.json
  MC:        {meta_data}/msrvtt_mc_test.jsonl
  regions:   {object_dir}/{video_id}/{frame}.npz

Retrieval items are the split's videos in sorted id order, each with its
captions in annotation order (what the JAX adapter's pandas `groupby`
gives). The jsfusion cut keeps one caption a val/test video, at the index
that `jsfusion_val_caption_idx.pkl` holds for it: an .npy array, aligned
with the sorted video ids. A pickled pandas Series in that file is refused
(the port does not use pandas).
"""
from __future__ import annotations

import os
import random
from typing import Any, Dict

import numpy as np

from demovlp_tpu_torch.data.datasets.base import RegionDataset, meta_data_dir
from demovlp_tpu_torch.data.datasets.table import is_nan, read_table, sample_rows
from demovlp_tpu_torch.utils.io import load_json, load_jsonl

_NPY_MAGIC = b"\x93NUMPY"


def _split_lists(cut):
    """(train list, test list, jsfusion caption-index file or None)."""
    if cut == "miech":
        return "train_list_miech.txt", "test_list_miech.txt", None
    if cut == "jsfusion":
        return "train_list_jsfusion.txt", "val_list_jsfusion.txt", "jsfusion_val_caption_idx.pkl"
    if cut in {"full-val", "full-test"}:
        return ("train_list_full.txt",
                "val_list_full.txt" if cut == "full-val" else "test_list_full.txt", None)
    if cut in {"val", "public_server_val", "public_server_test"}:
        return "train_list.txt", f"{cut}_list.txt" if cut == "val" else f"{cut}.txt", None
    raise ValueError(f"unrecognised MSRVTT split: {cut}")


def _caption_index(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        magic = fh.read(len(_NPY_MAGIC))
    if magic != _NPY_MAGIC:
        raise ValueError(f"{path}: not an .npy array (a pickled pandas Series needs pandas, "
                         "which the port does not use); save the caption indices, in "
                         "sorted video-id order, with np.save")
    return np.asarray(np.load(path, allow_pickle=True)).ravel()


class MSRVTTObjectSelect(RegionDataset):
    def _load_metadata(self):
        annotations = load_json(os.path.join(self.metadata_dir, "annotation",
                                              "MSR_VTT.json"))["annotations"]
        split_dir = os.path.join(self.metadata_dir, "high-quality", "structured-symlinks")
        train_list, test_list, cap_idx_file = _split_lists(self.cut)
        train_ids = [r[0] for r in read_table(os.path.join(split_dir, train_list), sep=",",
                                              names=["videoid"])]
        test_ids = [r[0] for r in read_table(os.path.join(split_dir, test_list), sep=",",
                                             names=["videoid"])]
        self.split_sizes = {"train": len(train_ids), "val": len(test_ids),
                            "test": len(test_ids)}
        keep = set(train_ids if self.split == "train" else test_ids)
        groups: Dict[Any, list] = {}
        for ann in annotations:
            vid = ann.get("image_id", float("nan"))
            if vid in keep and not is_nan(vid):
                groups.setdefault(vid, []).append(ann.get("caption", float("nan")))
        caps = [[vid, groups[vid]] for vid in sorted(groups)]
        if self.subsample < 1:
            caps = sample_rows(caps, self.subsample)
        if cap_idx_file is not None and self.split != "train":
            idx = _caption_index(os.path.join(split_dir, cap_idx_file))
            if len(idx) != len(caps):
                raise ValueError(f"{cap_idx_file}: {len(idx)} caption indices for "
                                 f"{len(caps)} videos")
            caps = [[vid, [captions[int(i)]]] for (vid, captions), i in zip(caps, idx)]
        self.metadata = caps  # [video id, captions]

    def _object_path(self, index: int) -> str:
        return os.path.join(self.object_dir, self.metadata[index][0])

    def _text(self, index: int, rng: np.random.Generator) -> str:
        captions = self.metadata[index][1]
        sample_mode = self.text_params.get("caption_sample", "rand")
        if self.split in ("train", "val") and sample_mode == "rand":
            return captions[int(rng.integers(0, len(captions)))]
        return captions[0]


class MSRVTTQAObjectSelect(RegionDataset):
    def _load_metadata(self):
        meta_dir = meta_data_dir()
        self.ans2label = load_json(os.path.join(meta_dir, "msrvtt_train_ans2label.json"))
        split_files = {"train": "msrvtt_qa_train.jsonl", "test": "msrvtt_qa_test.jsonl",
                       "val": "msrvtt_qa_val.jsonl"}
        raw = load_jsonl(os.path.join(meta_dir, split_files[self.split]))
        if self.subsample < 1:
            n = int(len(raw) * self.subsample)
            random.shuffle(raw)
            raw = raw[:n]
        self.metadata = [
            dict(question=d["question"], vid_id=d["video_id"], answer=d["answer"],
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


class MSRVTTMCObjectSelect(RegionDataset):
    def _load_metadata(self):
        raw = load_jsonl(os.path.join(meta_data_dir(), "msrvtt_mc_test.jsonl"))
        if self.subsample < 1:
            n = int(len(raw) * self.subsample)
            random.shuffle(raw)
            raw = raw[:n]
        self.metadata = [
            dict(id=d["qid"], vid_id=d["clip_name"], answer=d["answer"], options=d["options"])
            for d in raw
        ]
        self.id2answer = {d["id"]: int(d["answer"]) for d in self.metadata}
        self.id2data = {d["id"]: d for d in self.metadata}

    def _object_path(self, index: int) -> str:
        return os.path.join(self.object_dir, self.metadata[index]["vid_id"])

    def _text(self, index: int, rng):
        return self.metadata[index]["options"]

    def _extras(self, index: int) -> Dict[str, Any]:
        d = self.metadata[index]
        return {"label": d["answer"], "mc_id": d["id"]}
