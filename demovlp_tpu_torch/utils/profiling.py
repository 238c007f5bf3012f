"""Profiling and tracing hooks (counterpart of demovlp_tpu/utils/profiling.py):
a `torch.profiler` trace exported for Chrome's trace viewer (or Perfetto),
the program's own spans and counters, and the card's memory statistics.

Spans and counters record only while a `torch.profiler` session runs
(`recording()`: torch's process-wide flag, seen from every thread, where
`torch.autograd._profiler_enabled()` is true only on the thread that
opened the session). With no session, `span` makes that one check and
returns a shared no-op context, and `count` returns. While
a session runs, each span is kept on the host clock
(`time.perf_counter_ns()`) with the index of its parent (the span open on
its thread when it opened), its thread and its counters, in a buffer of
`MAX_SPANS` (spans beyond it are counted in `dropped`, not kept); it also
enters `torch.profiler.record_function`, so the session's Chrome trace
holds it as a `user_annotation` event on the trace's clock. `recorded()`
returns what was kept, `clear()` empties it; `trace()` clears it when it
opens and writes `spans.json` beside `trace.json` when it closes.
`span_both_ways` spans a block's forward and, on the thread that runs it,
its backward under one name.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _torch_profiler_state

TRACE_FILE = "trace.json"
SPANS_FILE = "spans.json"
#: spans kept between two clears; later ones are only counted
MAX_SPANS = 1 << 18

# a kept span's fields, in the list the recorder holds while it is open
_NAME, _INDEX, _PARENT, _THREAD, _START, _END, _COUNTERS = range(7)


def recording() -> bool:
    """True while a profiler session runs in this process, when spans and
    counters record; for a caller whose counter costs work to compute."""
    return _torch_profiler_state._is_profiler_enabled


class Span(NamedTuple):
    """A closed or open span (`end_ns` None while open); `parent` is the
    index in `recorded()["spans"]` of the span it opened inside, -1 for a
    root."""
    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: int
    thread: int
    counters: Dict[str, float]


class _Recorder:
    def __init__(self, limit: int):
        self.limit = limit
        self._lock = threading.Lock()
        self._local = threading.local()
        self.clear()

    def clear(self) -> None:
        with self._lock:
            self._spans: List[list] = []
            self._totals: Dict[str, float] = {}
            self._dropped = 0

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = stack = []
            return stack

    def open(self, name: str) -> Optional[list]:
        stack = self._stack()
        top = stack[-1] if stack else None
        with self._lock:
            spans = self._spans
            if len(spans) >= self.limit:
                self._dropped += 1
                rec = None
            else:
                # a parent kept before the last clear is not in this buffer
                parent = (top[_INDEX] if top is not None and top[_INDEX] < len(spans)
                          and spans[top[_INDEX]] is top else -1)
                rec = [name, len(spans), parent, threading.get_ident(), 0, None, None]
                spans.append(rec)
        stack.append(rec)
        if rec is not None:
            rec[_START] = time.perf_counter_ns()
        return rec

    def close(self, rec: Optional[list]) -> None:
        end = time.perf_counter_ns()
        if rec is not None:
            rec[_END] = end
        self._stack().pop()

    def count(self, name: str, n: float) -> None:
        stack = self._stack()
        rec = stack[-1] if stack else None
        with self._lock:
            self._totals[name] = self._totals.get(name, 0) + n
            if rec is not None:
                if rec[_COUNTERS] is None:
                    rec[_COUNTERS] = {}
                rec[_COUNTERS][name] = rec[_COUNTERS].get(name, 0) + n

    def recorded(self) -> Dict[str, Any]:
        with self._lock:
            spans = [Span(r[_NAME], r[_START], r[_END], r[_PARENT], r[_THREAD],
                          dict(r[_COUNTERS] or {})) for r in self._spans]
            return {"spans": spans, "counters": dict(self._totals), "dropped": self._dropped,
                    "main_thread": threading.main_thread().ident}


_RECORDER = _Recorder(MAX_SPANS)


class _NoSpan:
    """The span of a process with no profiler session: does nothing."""
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("_name", "_rf", "_rec")

    def __init__(self, name: str):
        self._name = name

    # the record_function inside the recorded span: its calls into torch
    # release the interpreter's lock, and a wait to take it back is the span's
    def __enter__(self) -> None:
        self._rec = _RECORDER.open(self._name)
        self._rf = torch.profiler.record_function(self._name)
        self._rf.__enter__()

    def __exit__(self, *exc) -> bool:
        self._rf.__exit__(*exc)
        _RECORDER.close(self._rec)
        return False


def span(name: str):
    """A named span around a block, recorded only while a profiler session
    runs (the module docstring); a context manager."""
    if not _torch_profiler_state._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


def count(name: str, n: float) -> None:
    """Add `n` to counter `name` of this thread's innermost open span (and
    to the total), only while a profiler session runs."""
    if _torch_profiler_state._is_profiler_enabled:
        _RECORDER.count(name, n)


class _Pending:
    """The span a backward opened, handed to the backward that closes it."""
    __slots__ = ("span",)

    def __init__(self):
        self.span = None


class _OpenInBackward(torch.autograd.Function):
    """Identity on a block's output; its backward, the first of the
    block's to run, opens the span."""

    @staticmethod
    def forward(ctx, y, pending, name):
        ctx.pending, ctx.name = pending, name
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        ctx.pending.span = span(ctx.name)
        ctx.pending.span.__enter__()
        return grad, None, None


class _CloseInBackward(torch.autograd.Function):
    """Identity on a block's input; its backward, the last of the block's
    to run, closes the span."""

    @staticmethod
    def forward(ctx, x, pending):
        ctx.pending = pending
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        opened, ctx.pending.span = ctx.pending.span, None
        if opened is not None:
            opened.__exit__(None, None, None)
        return grad, None


def span_both_ways(name: str, fn, x: torch.Tensor, *args):
    """`fn(x, *args)` inside span `name`, and its backward inside a span
    of the same name (on the thread that runs the backward), so the
    kernels of both directions can be attributed to the block. Only while
    a profiler session runs; otherwise a plain call. The backward's span
    opens at the gradient of the output and closes at the gradient of `x`,
    so it needs `x` to require grad (else only the forward is spanned)."""
    if not _torch_profiler_state._is_profiler_enabled:
        return fn(x, *args)
    with _Span(name):
        if not (torch.is_grad_enabled() and x.requires_grad):
            return fn(x, *args)
        pending = _Pending()
        y = fn(_CloseInBackward.apply(x, pending), *args)
        return _OpenInBackward.apply(y, pending, name)


def recorded() -> Dict[str, Any]:
    """{"spans": [Span] in the order they opened, "counters": {name: total},
    "dropped": spans not kept, "main_thread": the main thread's ident}."""
    return _RECORDER.recorded()


def clear() -> None:
    """Forget every span and counter kept so far."""
    _RECORDER.clear()


@contextlib.contextmanager
def trace(log_dir, device=None) -> Iterator[torch.profiler.profile]:
    """Profile the block: host activity, plus the card's kernels and copies
    when `device` is a CUDA device. The Chrome trace is written to
    `log_dir/trace.json` and the program's spans to `log_dir/spans.json`
    when the block ends (also when it raises). Yields the profiler, for
    `key_averages()`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    clear()
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(str(log_dir / TRACE_FILE))
        rec = recorded()
        rec["spans"] = [s._asdict() for s in rec["spans"]]
        (log_dir / SPANS_FILE).write_text(json.dumps(rec))


def device_memory_stats() -> dict:
    """`torch.cuda.memory_stats` of each visible card, by "cuda:<i>"; {}
    where there is no card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
