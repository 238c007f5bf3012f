"""Profiling and tracing hooks (counterpart of demovlp_tpu/utils/profiling.py):
a `torch.profiler` trace exported for Chrome's trace viewer (or Perfetto),
named spans inside it, a blocking step timer with summary statistics, and
the card's memory statistics.
"""
from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Any, Iterator, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir, device=None) -> Iterator[torch.profiler.profile]:
    """Profile the block: host activity, plus the card's kernels and copies
    when `device` is a CUDA device. The Chrome trace is written to
    `log_dir/trace.json` when the block ends (also when it raises). Yields
    the profiler, for `key_averages()`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(str(log_dir / TRACE_FILE))


def annotate(name: str) -> torch.profiler.record_function:
    """A named span in the trace (a `user_annotation` event on the host
    timeline); a context manager."""
    return torch.profiler.record_function(name)


def _synchronize(result: Any) -> None:
    """Wait for the card of the first CUDA tensor in `result` (a tensor or
    nested dicts, lists and tuples of them), as jax.block_until_ready
    waits for a result."""
    stack = [result]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
                return
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)


class StepTimer:
    """Blocking per-step wall-clock timer with summary stats. Call
    `observe(result)` once per step with any tensor of the step's outputs:
    it waits for that tensor's card, then reads the clock. The first
    `warmup` steps (first-use costs) are excluded."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times = []
        self._n = 0
        self._t = None

    def observe(self, result=None) -> Optional[float]:
        if result is not None:
            _synchronize(result)
        now = time.perf_counter()
        dt = None
        if self._t is not None and self._n >= self.warmup:
            dt = now - self._t
            self.times.append(dt)
        self._t = now
        self._n += 1
        return dt

    def summary(self) -> dict:
        if not self.times:
            return {"steps": 0}
        ts = sorted(self.times)
        n = len(ts)
        return {
            "steps": n,
            "mean_s": sum(ts) / n,
            "p50_s": ts[n // 2],
            "p90_s": ts[int(n * 0.9)],
            "min_s": ts[0],
            "max_s": ts[-1],
        }


def device_memory_stats() -> dict:
    """`torch.cuda.memory_stats` of each visible card, by "cuda:<i>"; {}
    where there is no card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}


def dump_profile(log_dir, timer: StepTimer) -> None:
    path = Path(log_dir) / "step_times.json"
    path.write_text(json.dumps({"summary": timer.summary()}, indent=2))
