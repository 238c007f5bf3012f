"""Wall-clock timer (copy of demovlp_tpu/utils/timer.py, the reference's
utils/util.py Timer)."""
from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.cache = time.time()

    def check(self) -> float:
        """Seconds since the last check (or reset, or construction)."""
        now = time.time()
        duration = now - self.cache
        self.cache = now
        return duration

    def reset(self) -> None:
        self.cache = time.time()
