"""data_wait_ms.train: the trainer's mean wait a step in `next()` on its
train loader in the traced window, timed by the benchmark's loader
wrapper (harness/loader.py)."""


def read(w):
    waits = w.get("data_waits_s")
    if w.get("kind") != "train" or not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
