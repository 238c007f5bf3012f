"""What a run hands back, the checks that decide `correct`, the device's
description and the result line."""
from __future__ import annotations

import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

#: top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "demovlp_tpu")


@dataclass
class Check:
    """One number compared with its limit; it passes when value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    setup_s: float
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Check]
    device: Dict[str, Any]
    window: Dict[str, Any] = field(default_factory=dict)  # what the per-layer readers read
    notes: List[str] = field(default_factory=list)  # failures the checks cannot express

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks) and not self.notes


def process_start() -> float:
    """This process's start on the `time.time()` clock, from /proc (the
    interpreter's own start-up included); the clock at call time where
    /proc is absent."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def device_info(device: torch.device, chips: int) -> Dict[str, Any]:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def result_line(outcome: Outcome, metrics: Dict[str, Dict[str, Any]],
                breakdown: Optional[Dict[str, list]] = None) -> str:
    out: Dict[str, Any] = {
        "correct": outcome.correct,
        "attempted": int(outcome.attempted),
        "failed": int(outcome.failed),
        "metrics": metrics,
        "device": outcome.device,
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return json.dumps(out)


def report_checks(outcome: Outcome) -> None:
    """Each compared number beside its limit, as the last lines on stderr."""
    for note in outcome.notes:
        print(f"[check] FAILED: {note}", file=sys.stderr)
    for c in outcome.checks:
        print(f"[check] {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
