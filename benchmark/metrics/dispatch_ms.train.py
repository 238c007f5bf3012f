"""dispatch_ms.train: the host's time a step in the program's `train.step`
span (the step function: forward, losses, backward and optimizer
enqueued) in the traced window (harness/program_spans.py)."""
from benchmark.harness import program_spans


def read(w):
    return program_spans.ms_per(w, "train", "train.step", "steps")
