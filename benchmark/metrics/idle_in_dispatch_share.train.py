"""idle_in_dispatch_share.train: the share of the traced window's device
idle time during which the main thread was inside the program's
`train.step` span, its children included (harness/program_spans.py)."""
from benchmark.harness import program_spans


def read(w):
    return program_spans.idle_share_inside(w, "train", "train.step")
