"""upload_ms.train: the host's time a step in the program's `train.upload`
span (steps.batch_to_device: the host cast of the regions, pinning and
the copies' enqueue) in the traced window (harness/program_spans.py)."""
from benchmark.harness import program_spans


def read(w):
    return program_spans.ms_per(w, "train", "train.upload", "steps")
