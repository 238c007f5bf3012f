"""A wrapper around the trainer's train loader: it times each `next()`
(the host data layer's wait, as the trainer sees it), hands out a fixed
number of batches or batches until a deadline, and keeps one iteration of
the wrapped loader running across the trainer's epoch calls, so the
checked steps, the warm-up and the window draw consecutive batches of one
epoch and no batch twice."""
from __future__ import annotations

import time
from typing import Any, Iterator, List, Optional, Tuple


class TimedLoader:
    def __init__(self, loader):
        self.loader = loader
        self.batch_size = loader.batch_size
        self.dataset_name = getattr(loader, "dataset_name", "")
        self._it: Optional[Iterator[Any]] = None
        self.quota: Optional[int] = None
        self.deadline: Optional[float] = None
        self.waits: List[Tuple[float, float]] = []  # (start, end) host clock of each next()

    def __len__(self) -> int:
        return len(self.loader)

    def set_epoch(self, epoch: int) -> None:
        if self._it is None:  # one epoch for the whole run
            self.loader.set_epoch(epoch)

    def __iter__(self):
        if self._it is None:
            self._it = iter(self.loader)
        n = 0
        while True:
            if self.quota is not None and n >= self.quota:
                return
            if self.deadline is not None and time.perf_counter() >= self.deadline:
                return
            t0 = time.perf_counter()
            try:
                batch = next(self._it)
            except StopIteration:
                raise RuntimeError("the train loader's epoch ended before the window; "
                                   "the traffic's samples_per_epoch is too small") from None
            self.waits.append((t0, time.perf_counter()))
            n += 1
            yield batch

    def close(self) -> None:
        """Stop the wrapped loader's producer thread and wait for it."""
        if self._it is not None:
            self._it.close()
            self._it = None
