"""Eval-path data loader (cut-down copy of demovlp_tpu/data/loader.py).

Unshuffled, keeps the final partial batch, one process (`process_index` 0
of `process_count` 1, passed explicitly). A background thread assembles
the next batches with a thread pool while the caller consumes the current
one. Training loaders (shuffle, drop_last, length grouping, multi-process
sharding) wait for a later slice.
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
    """Iterates the dataset in order, in batches of `batch_size` (the last
    one may be short)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 8, drop_last: bool = False, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
        if shuffle or drop_last or (process_index, process_count) != (0, 1):
            raise NotImplementedError(
                "only the unshuffled single-process eval loader is ported"
            )
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.seed = seed

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def _fetch(self, idx: int) -> Dict[str, Any]:
        # (seed, epoch, index) as the JAX loader seeds it; eval is epoch 0
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 0, int(idx)]))
        return self.dataset.get_item(int(idx), rng)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        n = len(self.dataset)
        batches = [np.arange(s, min(s + self.batch_size, n))
                   for s in range(0, n, self.batch_size)]
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
    """Config-surface constructor (the JAX package's kwargs); eval splits only."""

    def __init__(self, dataset_name: str, text_params: dict, object_params: dict,
                 split: str = "test", batch_size: int = 1, num_workers: int = 1,
                 shuffle: bool = False, drop_last: Optional[bool] = None,
                 seed: int = 0, **_unused):
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
