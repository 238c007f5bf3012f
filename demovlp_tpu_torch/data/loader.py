"""Data loader (cut-down copy of demovlp_tpu/data/loader.py), one process
(`process_index` 0 of `process_count` 1, passed explicitly).

Train loaders shuffle with the permutation
`default_rng(SeedSequence([seed, epoch])).permutation(n)` and drop the last
partial batch; eval loaders keep the dataset order and the partial batch.
Sample i of epoch e is drawn with `SeedSequence([seed, e, i])`, so the
batches equal the JAX loader's batch for batch. A background thread
assembles the next batches with a thread pool while the caller consumes
the current one. Length grouping and multi-process sharding wait for a
later slice.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from demovlp_tpu_torch.data.datasets import dataset_object_loader

_PREFETCH = 2  # batches assembled ahead of the consumer


def collate(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack per-sample dicts into a fixed-shape numpy batch."""
    return {
        "object": np.stack([it["object"] for it in items]).astype(np.float32),
        "object_mask": np.stack([it["object_mask"] for it in items]).astype(np.float32),
        "text": [it["text"] for it in items],
        "meta": [it["meta"] for it in items],
    }


class RegionDataLoader:
    """Iterates the dataset in batches of `batch_size`: shuffled per epoch
    and without the partial last batch for training, in order and with it
    for eval."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 8, drop_last: bool = False, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
        if (process_index, process_count) != (0, 1):
            raise NotImplementedError("multi-process loaders are not ported")
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
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _fetch(self, idx: int) -> Dict[str, Any]:
        # (seed, epoch, index) as the JAX loader seeds it
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch, int(idx)]))
        return self.dataset.get_item(int(idx), rng)

    def batch_indices(self) -> List[np.ndarray]:
        """This epoch's sample indices, batch by batch."""
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch]))
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        nb = len(self)
        return [order[i * self.batch_size:(i + 1) * self.batch_size] for i in range(nb)]

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        batches = self.batch_indices()
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
                    for idx in batches:
                        if not put(collate(list(pool.map(self._fetch, idx)))):
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
                 split: str = "train", batch_size: int = 1, num_workers: int = 1,
                 shuffle: bool = True, drop_last: Optional[bool] = None,
                 seed: int = 0, length_grouped: bool = False, **_unused):
        if length_grouped:
            raise NotImplementedError("length-grouped batching is not ported")
        dataset = dataset_object_loader(
            dataset_name, text_params=text_params, object_params=object_params,
            split=split,
        )
        if split != "train":
            shuffle = False
        if drop_last is None:
            drop_last = split == "train"
        super().__init__(dataset, batch_size=batch_size, shuffle=shuffle,
                         num_workers=num_workers, drop_last=drop_last, seed=seed)
