"""The traced window of harness/trace.py, with each kernel's launch: the
same profiler session over the card and the same `Trace`, and besides it,
read from the same exported Chrome trace, every kernel of the window with
the host time of the runtime or driver call that launched it (their
`correlation` ids matched), on the trace's clock. A reader can then
attribute device time to the program's spans that were open on the host
when the kernels were launched (program_spans.place puts the spans on
that clock)."""
from __future__ import annotations

import contextlib
import json
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

from benchmark.harness import trace as tracing

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

Launch = Tuple[str, float, float, float]  # (kernel, device start us, end us, launch us)


def kernel_launches(events: list, window: Tuple[float, float]) -> List[Launch]:
    """The window's kernels, each with its launch call's start."""
    launched: Dict[int, float] = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            launched[int(corr)] = float(e["ts"])
    t0, t1 = window
    out = []
    for e in events:
        if e.get("cat") != "kernel" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        corr = (e.get("args") or {}).get("correlation")
        if b < t0 or a > t1 or corr is None or int(corr) not in launched:
            continue
        out.append((str(e.get("name", "")), a, b, launched[int(corr)]))
    return out


@contextlib.contextmanager
def traced(out_dir: Path) -> Iterator[dict]:
    """trace.traced, whose holder also gets "launches" (kernel_launches)."""
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "trace.json"
    holder: dict = {}
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
        holder["trace"] = tr = tracing._read(path)
        holder["launches"] = kernel_launches(json.loads(path.read_text())["traceEvents"],
                                             tr.window)
    finally:
        path.unlink(missing_ok=True)


@contextlib.contextmanager
def maybe_traced(on: bool, out_dir: Path) -> Iterator[dict]:
    if not on:
        yield {}
        return
    with traced(out_dir) as holder:
        yield holder
