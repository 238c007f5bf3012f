"""Frame sampling over linspace intervals (copy of
demovlp_tpu/data/sampling.py, the same generator calls in the same order).

Train: one random frame per interval; eval: the interval midpoint. An
interval of width 1 gives its one frame (the reference raises there and
swaps the whole sample for another).
"""
from __future__ import annotations

from typing import List

import numpy as np


def sample_frame_indices(
    num_segments: int,
    vlen: int,
    mode: str = "rand",
    rng: np.random.Generator | None = None,
    fix_start: int | None = None,
) -> List[int]:
    acc_samples = min(num_segments, vlen)
    intervals = np.linspace(start=0, stop=vlen, num=acc_samples + 1).astype(int)
    ranges = [(intervals[i], intervals[i + 1] - 1) for i in range(len(intervals) - 1)]
    if mode == "rand":
        if rng is None:
            rng = np.random.default_rng()
        idxs = [int(rng.integers(lo, hi)) if hi > lo else int(lo) for lo, hi in ranges]
        return sorted(idxs)
    if fix_start is not None:
        return [int(lo) + fix_start for lo, _ in ranges]
    if mode == "uniform":
        return [int((lo + hi) // 2) for lo, hi in ranges]
    raise NotImplementedError(mode)
