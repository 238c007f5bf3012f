"""video_attn_share.train: the share of the traced window's device busy
time spent in kernels launched while one of the program's divided-
attention spans was open on the host: `video.time_attn` or
`video.space_attn` (models/frozen.py; each block's time and space
attention, their q, k, v and out projections included, forward and
backward), on any thread (the backward's spans open on the thread that
runs it). The launches come from the trace (harness/launches.py), the
spans from the program's recorder on the trace's clock
(harness/program_spans.py). Nothing where the program records no such
span."""
import bisect

from benchmark.harness import program_spans

SPANS = ("video.time_attn", "video.space_attn")


def inside(launches, intervals):
    """Σ device us of the launches whose launch time falls in one of the
    intervals (start, end); a kernel counts whole."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starts = [a for a, _ in merged]
    total = 0.0
    for _, a, b, at in launches:
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= merged[i][1]:
            total += b - a
    return total


def read(w):
    trace, launches = w.get("trace"), w.get("launches")
    if w.get("kind") != "train" or trace is None or not launches or trace.busy_s <= 0:
        return None
    placed = program_spans.place(w)
    if placed is None:
        return None
    intervals = [(a, b) for name, a, b, _, _ in placed.spans if name in SPANS]
    if not intervals:
        return None
    return 100.0 * inside(launches, intervals) / 1e6 / trace.busy_s
