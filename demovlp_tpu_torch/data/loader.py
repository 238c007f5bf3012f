"""Data loader (copy of demovlp_tpu/data/loader.py): each process reads
its shard (`process_index` of `process_count`; by default this process of
the torch.distributed world, parallel/mesh.py).

Train loaders shuffle with the permutation
`default_rng(SeedSequence([seed, epoch])).permutation(n)` and drop the last
partial batch; eval loaders keep the dataset order and the partial batch.
Sample i of epoch e is drawn with `SeedSequence([seed, e, i])`, so the
batches equal the JAX loader's batch for batch. A background thread
assembles the next batches with a thread pool while the caller consumes
the current one. Where the dataset decodes its regions with the base
class's reader and the native reader is on (data/native.py), one native
call decodes a whole batch into its final buffers (`_fetch_batch_native`);
otherwise each sample is fetched on its own and the samples are stacked.

Length grouping (`length_grouped`, train loaders only: shuffled and
dropping the last batch; inert elsewhere) gives the JAX loader's batches
index for index: the epoch's permutation is partitioned stably by
caption-length class (the smallest of the trainer's `text_buckets`, else
of `DEFAULT_TEXT_BUCKETS`, that holds the word count + 2 for [CLS] and
[SEP]), and the batch order is then shuffled with
`SeedSequence([seed, epoch, 1])`. `length_grouped: "sort"` (the JAX
loader's measurement mode) sorts that permutation stably by exact caption
length instead, `idx[argsort(lens[idx], kind="stable")]`, at the same place
and with the same batch-order shuffle after.

Shards (JAX loader.py:165-210): a train loader truncates the epoch's
permutation to `per_process * P`, length-groups that global order (where
asked), then takes every P-th index from its own; an eval loader takes a
contiguous ceil(n / P) share, the tail wrapped around cyclically, and
its batches carry `sample_valid` flags (0 on the wrapped duplicates)
where the shares had to be padded.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from demovlp_tpu_torch.data import native
from demovlp_tpu_torch.data.datasets import RegionDataset, dataset_object_loader
from demovlp_tpu_torch.data.regions import REGION_DIM
from demovlp_tpu_torch.data.transforms import init_transform_dict
from demovlp_tpu_torch.parallel.mesh import process_count as _process_count
from demovlp_tpu_torch.parallel.mesh import process_index as _process_index

_PREFETCH = 2  # batches assembled ahead of the consumer
# [CLS] + [SEP]: the margin between the word-count length proxy and the
# tokenized length that the bucket edges are compared against
_TOKENIZER_SPECIALS = 2
# the JAX loader's class edges, used where the trainer sets no text_buckets
DEFAULT_TEXT_BUCKETS = (32, 48, 64)


def _task_fields(batch: Dict[str, Any], items: List[Dict[str, Any]]) -> Dict[str, Any]:
    if "label" in items[0]:
        batch["label"] = np.asarray([it["label"] for it in items], dtype=np.int32)
    if "question_id" in items[0]:
        batch["question_id"] = np.asarray([it["question_id"] for it in items], dtype=np.int64)
    if "mc_id" in items[0]:
        batch["mc_id"] = [it["mc_id"] for it in items]
    return batch


def collate(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack per-sample dicts into a fixed-shape numpy batch."""
    return _task_fields({
        "object": np.stack([it["object"] for it in items]).astype(np.float32),
        "object_mask": np.stack([it["object_mask"] for it in items]).astype(np.float32),
        "text": [it["text"] for it in items],
        "meta": [it["meta"] for it in items],
    }, items)


class RegionDataLoader:
    """Iterates the dataset in batches of `batch_size`: shuffled per epoch
    and without the partial last batch for training (length-grouped where
    asked), in order and with it for eval."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 8, drop_last: bool = False, seed: int = 0,
                 process_index: Optional[int] = None, process_count: Optional[int] = None,
                 length_grouped: bool | str = False,
                 text_buckets: Optional[Sequence[int]] = None):
        if process_index is None or process_count is None:
            process_index, process_count = _process_index(), _process_count()
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} of {process_count}")
        self.process_index, self.process_count = process_index, process_count
        if length_grouped not in (False, True, "sort"):
            raise NotImplementedError(f"length_grouped={length_grouped!r}: expected a bool "
                                      "or 'sort'")
        self.length_group_mode = "sort" if length_grouped == "sort" else "class"
        self.length_grouped = bool(length_grouped and shuffle and drop_last)
        # the class edges: those the trainer trims to, so the two agree
        self.text_buckets = tuple(sorted(text_buckets or DEFAULT_TEXT_BUCKETS))
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.epoch = 0
        self.dataset_name = getattr(dataset, "dataset_name", type(dataset).__name__)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n, p = len(self.dataset), self.process_count
        if self.drop_last:
            return n // p // self.batch_size
        share = -(-n // p)
        return -(-share // self.batch_size)

    def _fetch(self, idx: int) -> Dict[str, Any]:
        return self.dataset.get_item(int(idx), self._rng(idx))

    def _rng(self, idx) -> np.random.Generator:
        # (seed, epoch, index) as the JAX loader seeds it
        return np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch, int(idx)]))

    def _native_batch_reader(self):
        """The native reader where whole-batch decoding applies: the native
        reader is on and the dataset decodes with the base class's
        `_load_objects` (CC3M's images and the synthetic data override it
        and take the per-sample path); else None."""
        ds = self.dataset
        if (not native.native_enabled() or not isinstance(ds, RegionDataset)
                or type(ds)._load_objects is not RegionDataset._load_objects):
            return None
        return native.get_native_reader()

    def _fetch_batch_native(self, batch_idx, reader, pool) -> Dict[str, Any]:
        """One native call decodes the whole batch's frame files into the
        final (B, F, K, 2054) buffers. `plan_item` draws each sample's
        generator values as `get_item` does, so the batch equals
        `collate(pool.map(self._fetch, batch_idx))`; a row whose file the
        reader cannot decode is redone on the per-sample path, with the same
        generator (counted in native.STATS["rows_redone"])."""
        ds = self.dataset
        plans = list(pool.map(lambda idx: ds.plan_item(int(idx), self._rng(idx)), batch_idx))
        b, f, k = len(plans), int(ds.segments), ds.object_num
        feat = np.zeros((b * f, k, REGION_DIM), dtype=np.float32)
        mask = np.zeros((b * f, k), dtype=np.float32)
        lens = np.zeros(b * f, dtype=np.int32)
        # a subclass whose plan gives another frame count than `segments`
        # takes the per-sample path (placeholders decode to an error status)
        bad = np.array([len(paths) != f for paths, _ in plans])
        flat = [p for paths, _ in plans for p in (paths if len(paths) == f else [""] * f)]
        status = reader.read_paths_into(flat, k, feat, mask, lens)
        feat = feat.reshape(b, f, k, REGION_DIM)
        mask = mask.reshape(b, f, k)
        bad |= status.reshape(b, f).any(axis=1)
        items = [data for _, data in plans]
        for i in np.nonzero(bad)[0]:
            item = self._fetch(int(batch_idx[i]))
            feat[i] = item["object"]
            mask[i] = item["object_mask"]
            items[i] = item
        native.count("rows_redone", int(bad.sum()))
        return _task_fields({"object": feat, "object_mask": mask,
                             "text": [d["text"] for d in items],
                             "meta": [d["meta"] for d in items]}, items)

    def _length_group(self, order: np.ndarray) -> np.ndarray:
        """The permutation partitioned stably by length class, the epoch's
        random order kept within each class; in "sort" mode sorted stably
        by exact length."""
        lens = np.asarray(self.dataset.text_lengths())
        if self.length_group_mode == "sort":
            return order[np.argsort(lens[order], kind="stable")]
        buckets = np.asarray(self.text_buckets)
        # class len(buckets): fits no bucket (pads to the full length)
        cls = np.searchsorted(buckets, lens[order] + _TOKENIZER_SPECIALS, side="left")
        return np.concatenate([order[cls == c] for c in range(len(buckets) + 1)])

    def host_indices(self):
        """(this process's sample indices, their validity flags or None
        where every index is a real sample), as JAX `_host_indices`."""
        n, p = len(self.dataset), self.process_count
        if self.shuffle:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch]))
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        if self.drop_last:
            per = n // p
            if per == 0:
                raise ValueError(f"dataset of {n} samples cannot be split over {p} processes")
            order = order[:per * p]
            if self.length_grouped:
                # the global order is grouped before striding, so every
                # process meets the same class boundaries at the same step
                order = self._length_group(order)
            return order[self.process_index::p], None
        share = -(-n // p)
        total = share * p
        padded = np.resize(order, total) if total > n else order  # cyclic wrap
        sl = slice(self.process_index * share, (self.process_index + 1) * share)
        return padded[sl], (None if total == n else (np.arange(total) < n)[sl])

    def _batches(self) -> List[tuple]:
        """This epoch's (sample indices, validity flags or None), batch by
        batch."""
        order, valid = self.host_indices()
        bs = self.batch_size
        spans = [(i * bs, (i + 1) * bs) for i in range(len(self))]
        if self.length_grouped and len(spans) > 1:
            # epoch position decorrelated from caption length
            brng = np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch, 1]))
            spans = [spans[j] for j in brng.permutation(len(spans))]
        return [(order[a:b], None if valid is None else valid[a:b]) for a, b in spans]

    def batch_indices(self) -> List[np.ndarray]:
        """This epoch's sample indices, batch by batch."""
        return [idx for idx, _ in self._batches()]

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        batches = self._batches()
        reader = self._native_batch_reader()
        out_q: queue.Queue = queue.Queue(maxsize=_PREFETCH)
        stop = threading.Event()
        sentinel = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for idx, flags in batches:
                        if reader is not None:
                            batch = self._fetch_batch_native(idx, reader, pool)
                        else:
                            batch = collate(list(pool.map(self._fetch, idx)))
                        if flags is not None:
                            batch["sample_valid"] = flags.astype(np.float32)
                        if not put(batch):
                            return
            except BaseException as exc:  # hand the failure to the consumer
                put(exc)
                return
            put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is sentinel:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # on exhaustion or early abandonment: release a blocked producer
            stop.set()
            try:
                while True:
                    out_q.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=30)


class MultiDistTextObjectVideoDataLoader(RegionDataLoader):
    """Config-surface constructor (the JAX package's kwargs)."""

    def __init__(self, dataset_name: str, text_params: dict, object_params: dict,
                 data_dir: str = "", object_dir: str = "", metadata_dir: Optional[str] = None,
                 split: str = "train", tsfm_params: Optional[dict] = None,
                 cut: Optional[str] = None, subsample: float = 1,
                 sliding_window_stride: int = -1, reader: str = "cv2", batch_size: int = 1,
                 num_workers: int = 1, shuffle: bool = True, drop_last: Optional[bool] = None,
                 seed: int = 0, length_grouped: bool | str = False,
                 text_buckets: Optional[Sequence[int]] = None,
                 process_index: Optional[int] = None, process_count: Optional[int] = None):
        dataset = dataset_object_loader(
            dataset_name, text_params=text_params, object_params=object_params,
            data_dir=data_dir, object_dir=object_dir, metadata_dir=metadata_dir, split=split,
            tsfms=init_transform_dict(**(tsfm_params or {})).get(split), cut=cut,
            subsample=subsample, sliding_window_stride=sliding_window_stride, reader=reader,
        )
        if split != "train":
            shuffle = False
        if drop_last is None:
            drop_last = split == "train"
        super().__init__(dataset, batch_size=batch_size, shuffle=shuffle,
                         num_workers=num_workers, drop_last=drop_last, seed=seed,
                         process_index=process_index, process_count=process_count,
                         length_grouped=length_grouped, text_buckets=text_buckets)
