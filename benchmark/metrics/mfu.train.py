"""mfu.train: the whole step's share of the card's dense bf16 peak in the
traced window: the frozen FLOP model of a step (counts/flops.py) times the
steps, over the window's seconds."""
from benchmark.counts import peaks


def read(w):
    p = peaks.peaks(w.get("device_name", ""))
    if w.get("kind") != "train" or p is None or not w.get("steps"):
        return None
    return 100.0 * w["flops_per_step"] * w["steps"] / w["window_s"] / p["bf16"]
