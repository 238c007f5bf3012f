"""The program's own spans (`demovlp_tpu_torch.utils.profiling`), read after
a traced window and put on the trace's clock.

The program records spans only while a profiler session runs, so what it
holds after a traced run is the window's. Its spans are on the host clock
in ns; the benchmark's spans (harness/trace.HostSpans) are on the trace's
clock in us. Each benchmark span of a pair encloses exactly one program
span: `bench.step_call` (around the trainer's step function) the step's
`train.step`, `bench.sharded_local_sims` a call's `serve.local_sims`. The
two lists are matched in order. A pair bounds the offset (trace time less
program time) from both sides: the program span opens no earlier and
closes no later than the benchmark span around it. The offset is the
middle of the range that every pair allows, not a median of each pair's
middle: on the card the main thread can wait up to the interpreter's
switch interval (5 ms) for the lock at a step's first operation while the
loader's threads run Python, which moves one edge of a pair and not the
other. Nothing is read where there are no pairs, where the two lists
differ in length, or where the pairs' ranges miss each other by more
than `MAX_DISAGREEMENT_US`: then the two clocks do not agree. A program
without the recorder (an older checkout) gives nothing either.

The device's idle time is then named by the program's spans: at each
moment of an idle gap, the spans open on the main thread, innermost last.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

#: per kind of cell: (the benchmark's span, the program span it encloses)
PAIRS = {"train": ("step_call", "train.step"), "query": ("sharded_local_sims", "serve.local_sims")}
#: the most by which the offsets that the pairs allow may miss each other, in us
MAX_DISAGREEMENT_US = 100.0
NO_SPAN = "(no span)"

Path = Tuple[str, ...]  # the spans open on the main thread, outermost first


@dataclass
class Placed:
    """The program's spans inside the window, on the trace's clock (us):
    (name, start, end, thread, counters)."""
    spans: List[Tuple[str, float, float, int, Dict[str, float]]]
    main: int
    offset_us: float
    disagreement_us: float  # 0 where every pair allows the offset
    pairs: int
    window: Tuple[float, float]
    segments: List[Tuple[float, float, Path]] = field(default_factory=list)

    def of(self, name: str):
        """The main thread's spans `name`."""
        return [s for s in self.spans if s[0] == name and s[3] == self.main]

    def clipped_us(self, name: str) -> float:
        """Σ time of the main thread's spans `name`, clipped to the window."""
        t0, t1 = self.window
        return sum(max(0.0, min(b, t1) - max(a, t0)) for _, a, b, _, _ in self.of(name))


def recorded() -> Optional[Dict[str, Any]]:
    """What the program recorded, or None where it has no recorder."""
    try:
        from demovlp_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "recorded", None)
    return read() if callable(read) else None


def fit(outer: List[Tuple[str, float, float]], inner) -> Optional[Tuple[float, float]]:
    """(offset us, disagreement us) from the benchmark spans and the program
    spans they enclose, matched in order (module docstring); None where
    there are none or the counts differ."""
    outer = sorted(outer, key=lambda e: e[1])
    inner = sorted(inner, key=lambda s: s.start_ns)
    if not outer or len(outer) != len(inner):
        return None
    lo = max(a - s.start_ns / 1e3 for (_, a, _), s in zip(outer, inner))
    hi = min(b - s.end_ns / 1e3 for (_, _, b), s in zip(outer, inner))
    return (lo + hi) / 2, max(0.0, lo - hi)


def segments(spans, window: Tuple[float, float]) -> List[Tuple[float, float, Path]]:
    """The window cut where one thread's spans (nested, (name, start, end,
    ...)) open and close: (start, end, the spans open there)."""
    t0, t1 = window
    out: List[Tuple[float, float, Path]] = []
    stack: List[Tuple[str, float, float]] = []
    t = t0

    def emit(end: float) -> None:
        nonlocal t
        a, b = max(t, t0), min(end, t1)
        if b > a:
            out.append((a, b, tuple(s[0] for s in stack)))
        t = max(t, end)

    for name, a, b, *_ in sorted(spans, key=lambda s: (s[1], -s[2])):
        while stack and stack[-1][2] <= a:
            emit(stack[-1][2])
            stack.pop()
        emit(a)
        stack.append((name, a, b))
    while stack:
        emit(stack[-1][2])
        stack.pop()
    emit(t1)
    return out


def place(w: Dict[str, Any], rec: Optional[Dict[str, Any]] = None) -> Optional[Placed]:
    """The program's spans on the trace's clock (module docstring), or
    None. Without `rec`, the program's recorder is read, once a window."""
    if rec is None and "_program_spans" in w:
        return w["_program_spans"]
    trace, kind = w.get("trace"), w.get("kind")
    out = None
    got = recorded() if rec is None else rec
    if trace is not None and kind in PAIRS and got and got.get("spans"):
        bench, prog = PAIRS[kind]
        main = got["main_thread"]
        closed = [s for s in got["spans"] if s.end_ns is not None]
        outer = trace.spans(bench)
        fitted = fit(outer, [s for s in closed if s.name == prog and s.thread == main])
        if fitted is not None and fitted[1] <= MAX_DISAGREEMENT_US:
            off = fitted[0]
            t0, t1 = trace.window
            spans = [(s.name, s.start_ns / 1e3 + off, s.end_ns / 1e3 + off, s.thread, s.counters)
                     for s in closed]
            spans = [s for s in spans if s[2] > t0 and s[1] < t1]
            out = Placed(spans, main, off, fitted[1], len(outer), trace.window)
            out.segments = segments([s for s in spans if s[3] == main], trace.window)
    if rec is None:
        w["_program_spans"] = out
    return out


def idle_by_path(w: Dict[str, Any], placed: Placed) -> Dict[Path, float]:
    """The window's device idle time (us) by the spans open on the main
    thread while it lasted."""
    gaps = sorted((a, b) for _, a, b in w["trace"].idle_gaps())
    out: Dict[Path, float] = {}
    i = 0
    for a, b, path in placed.segments:
        while i < len(gaps) and gaps[i][1] <= a:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < b:
            over = min(b, gaps[j][1]) - max(a, gaps[j][0])
            if over > 0:
                out[path] = out.get(path, 0.0) + over
            j += 1
    return out


def ms_per(w: Dict[str, Any], kind: str, name: str, units: str,
           rec: Optional[Dict[str, Any]] = None) -> Optional[float]:
    """Σ time of the main thread's spans `name` in the window (ms), over
    the window's `units` (steps or calls); None outside cells of `kind`."""
    if w.get("kind") != kind or not w.get(units):
        return None
    placed = place(w, rec)
    if placed is None:
        return None
    return placed.clipped_us(name) / 1e3 / w[units]


def idle_share_inside(w: Dict[str, Any], kind: str, name: str,
                      rec: Optional[Dict[str, Any]] = None) -> Optional[float]:
    """The share (%) of the window's device idle time during which the main
    thread was inside a span `name` (its children included); None outside
    cells of `kind`."""
    if w.get("kind") != kind:
        return None
    placed = place(w, rec)
    if placed is None:
        return None
    idle = idle_by_path(w, placed)
    total = sum(length for length, _, _ in w["trace"].idle_gaps())
    if total <= 0:
        return 0.0
    return 100.0 * sum(us for path, us in idle.items() if name in path) / total


def summary(w: Dict[str, Any], rec: Optional[Dict[str, Any]] = None) -> Optional[Dict[str, Any]]:
    """The tables of a traced window: its idle time by the innermost span
    open on the main thread (a root span's own time under its name), each
    span's count and time, the staging rates (the upload's and the
    gallery's bytes over their spans' time) and, for each span of the
    training loop, the share of its time in which a loader thread was in
    `data.batch`."""
    placed = place(w, rec)
    if placed is None:
        return None
    idle = idle_by_path(w, placed)
    total = sum(length for length, _, _ in w["trace"].idle_gaps())
    by_inner: Dict[str, float] = {}
    for path, us in idle.items():
        key = path[-1] if path else NO_SPAN
        by_inner[key] = by_inner.get(key, 0.0) + us
    spans: Dict[str, List[float]] = {}
    for name, a, b, thread, _ in placed.spans:
        key = name if thread == placed.main else f"{name} (other thread)"
        entry = spans.setdefault(key, [0, 0.0])
        entry[0] += 1
        entry[1] += (b - a) / 1e3
    rates = {}
    for name, counter in (("train.upload", "train.upload_bytes"),
                          ("serve.stage", "serve.staged_bytes")):
        took = placed.clipped_us(name)
        moved = sum(c.get(counter, 0) for _, _, _, _, c in placed.of(name))
        if took > 0:
            rates[name] = {"bytes": moved, "ms": took / 1e3, "GB_per_s": moved / took / 1e3}
    batches = [(a, b) for name, a, b, thread, _ in placed.spans
               if name == "data.batch" and thread != placed.main]
    overlapped = {}
    for name in ("train.prepare", "train.upload", "train.step", "train.read_metrics"):
        took = placed.clipped_us(name)
        if took > 0 and batches:
            over = sum(max(0.0, min(b, d) - max(a, c)) for _, a, b, _, _ in placed.of(name)
                       for c, d in batches)
            overlapped[name] = over / took
    return {
        "offset_us": placed.offset_us, "disagreement_us": placed.disagreement_us,
        "pairs": placed.pairs,
        "window_ms": (placed.window[1] - placed.window[0]) / 1e3, "idle_ms": total / 1e3,
        "idle_by_innermost_ms": {k: v / 1e3 for k, v in sorted(by_inner.items(),
                                                                key=lambda kv: -kv[1])},
        "spans": {k: {"count": n, "ms": ms} for k, (n, ms) in sorted(spans.items())},
        "staging": rates,
        "overlapped_by_data_batch": overlapped,
    }
