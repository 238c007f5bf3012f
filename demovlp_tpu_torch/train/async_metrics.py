"""One-step-delayed host read of per-step training metrics (copy of
demovlp_tpu/train/async_metrics.py).

Reading a loss on the host (`float(m["loss"])`) waits for the card to
finish that step. The train loop instead pushes step i's device metrics
and the consumer runs on step i-1's: by then step i is already queued on
the card, so the host only waits for work that finishes while step i runs,
and prepares batch i+1 meanwhile. Totals are the same; log lines lag one
step. Each consumption is span `train.read_metrics` (the host's wait for
the step's loss included).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

from demovlp_tpu_torch.utils import profiling


class DeferredMetrics:
    """Queue with exactly one entry in flight."""

    def __init__(self, consume: Callable[..., None]):
        self._consume = consume
        self._pending: Optional[Tuple[Any, tuple]] = None

    def push(self, metrics: Any, *ctx: Any) -> None:
        """Hand over step i's metrics (and loop context); consume step i-1's."""
        prev = self._pending
        self._pending = (metrics, ctx)
        if prev is not None:
            with profiling.span("train.read_metrics"):
                self._consume(prev[0], *prev[1])

    def flush(self) -> None:
        """Consume the last entry (after the loop)."""
        prev, self._pending = self._pending, None
        if prev is not None:
            with profiling.span("train.read_metrics"):
                self._consume(prev[0], *prev[1])
