"""The traced window: one `torch.profiler` session over the card (its
kernels, copies and fills, and the host's CUDA runtime calls), opened
after warm-up around the window and read back from its exported Chrome
trace. The session records no host operators: recording them slowed the
pre-training step by a further fifth.

The trace, and not `key_averages()`, is the source: a session opened
before the first training step of a process can leave the kernels that
the port launches through ctypes out of `key_averages()` while the
exported trace still holds them. The window's edges are the two device
synchronisations that open and close it (`edge`); the benchmark's own
host spans (`HostSpans`) are placed on the trace's clock from the first.
"""
from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime",)
#: the runtime call of `edge`: the window runs from the first of them to the last
EDGE = "cudaDeviceSynchronize"

Event = Tuple[str, float, float]  # (name, start us, end us)


def edge(device: torch.device) -> float:
    """Open or close the window: wait for the device (the trace's edge).
    Returns the host clock (perf_counter) once the wait is over."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


class HostSpans:
    """The benchmark's own spans on the host clock, around the calls it
    makes or wraps into the program's layers; `place` puts them on the
    trace's clock, given the host clock at the window's opening edge."""

    def __init__(self):
        self.spans: List[Tuple[str, float, float]] = []
        self._wrapped: List[Tuple[object, str, object]] = []

    def add(self, name: str, a: float, b: float) -> None:
        self.spans.append((name, a, b))

    def wrap(self, owner, attr: str, name: str) -> None:
        """Time every call of `owner.attr` as span `name`."""
        fn = getattr(owner, attr)

        def timed(*args, **kwargs):
            a = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.spans.append((name, a, time.perf_counter()))

        self._wrapped.append((owner, attr, fn))
        setattr(owner, attr, timed)

    def unwrap(self) -> None:
        for owner, attr, fn in reversed(self._wrapped):
            setattr(owner, attr, fn)
        self._wrapped.clear()

    def place(self, trace: "Trace", opened: float) -> None:
        t0 = trace.window[0]
        trace.host.extend((f"bench.{n}", t0 + (a - opened) * 1e6, t0 + (b - opened) * 1e6)
                          for n, a, b in self.spans)


@dataclass
class Trace:
    """The device's events and the host's spans inside the window."""
    window: Tuple[float, float]
    kernels: List[Event] = field(default_factory=list)
    copies: List[Event] = field(default_factory=list)  # gpu_memcpy and gpu_memset
    host: List[Event] = field(default_factory=list)  # cpu ops, runtime calls, bench spans

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def device_events(self) -> List[Event]:
        return sorted(self.kernels + self.copies, key=lambda e: e[1])

    def busy_intervals(self) -> List[List[float]]:
        """The union of the device's events, clipped to the window."""
        t0, t1 = self.window
        merged: List[List[float]] = []
        for _, a, b in self.device_events():
            a, b = max(a, t0), min(b, t1)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def spans(self, name: str) -> List[Event]:
        return [e for e in self.host if e[0] == f"bench.{name}"]

    def idle_gaps(self) -> List[Tuple[float, float, float]]:
        """(length us, start, end) of each stretch of the window in which
        the device ran nothing, longest first."""
        t0, t1 = self.window
        edges = [t0] + [x for ab in self.busy_intervals() for x in ab] + [t1]
        gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
                for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        return sorted(gaps, reverse=True)

    def host_during(self, a: float, b: float) -> str:
        """What the host was doing over [a, b]: the benchmark span that
        covers most of it, else the shortest runtime call that covers at
        least half of it; spans nest, so of several benchmark
        spans over the same stretch the innermost wins."""
        best: Optional[Tuple[float, float, float, str]] = None
        for name, s, e in self.host:
            over = min(b, e) - max(a, s)
            if over <= 0:
                continue
            if name.startswith("bench."):
                key = (2.0, over, -(e - s), name)
            elif over >= 0.5 * (b - a):
                key = (1.0, 0.0, -(e - s), name)
            else:
                continue
            if best is None or key > best:
                best = key
        return best[3] if best else "host outside any runtime call or benchmark span"


def _read(path: Path) -> Trace:
    events = json.loads(path.read_text())["traceEvents"]
    edges = sorted(float(e["ts"]) + float(e["dur"]) for e in events
                   if e.get("cat") == "cuda_runtime" and e.get("name") == EDGE)
    if len(edges) < 2:
        raise RuntimeError(f"the trace holds {len(edges)} {EDGE} calls; the window needs two")
    t0, t1 = edges[0], edges[-1]
    out = Trace(window=(t0, t1))
    for e in events:
        cat = e.get("cat")
        if cat not in DEVICE_CATS and cat not in HOST_CATS or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if b < t0 or a > t1:
            continue
        item = (str(e.get("name", "")), a, b)
        if cat == "kernel":
            out.kernels.append(item)
        elif cat in DEVICE_CATS:
            out.copies.append(item)
        else:
            out.host.append(item)
    return out


@contextlib.contextmanager
def traced(out_dir: Path) -> Iterator[Dict[str, Trace]]:
    """Profile the card over the block, which must run the window between
    two `edge` calls. Yields a dict that holds the Trace under "trace" once
    the block ends. The exported file is deleted after it is read."""
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "trace.json"
    holder: Dict[str, Trace] = {}
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    try:
        yield holder
    except BaseException:
        prof.stop()
        raise
    prof.stop()
    prof.export_chrome_trace(str(path))
    try:
        holder["trace"] = _read(path)
    finally:
        path.unlink(missing_ok=True)


@contextlib.contextmanager
def maybe_traced(on: bool, out_dir: Path) -> Iterator[Dict[str, Trace]]:
    """`traced` where `on`, else a block that yields an empty holder."""
    if not on:
        yield {}
        return
    with traced(out_dir) as holder:
        yield holder


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time and the longest idle gaps,
    each gap named by what the host was doing, in seconds as measured."""
    by_name: Dict[str, float] = {}
    for name, a, b in trace.device_events():
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = [[trace.host_during(a, b), length / 1e6] for length, a, b in trace.idle_gaps()[:top]]
    return {"device_ops": [[n[:200], s] for n, s in ops], "idle_gaps": gaps}
