"""mfu.query: the query calls' share of the card's dense bf16 peak in the
traced window: the frozen FLOP model of a call (counts/flops.py) times the
calls, over the window's seconds."""
from benchmark.counts import peaks


def read(w):
    p = peaks.peaks(w.get("device_name", ""))
    if w.get("kind") != "query" or p is None or not w.get("calls"):
        return None
    return 100.0 * w["flops_per_call"] * w["calls"] / w["window_s"] / p["bf16"]
