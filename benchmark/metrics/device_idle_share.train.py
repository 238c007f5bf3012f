"""device_idle_share.train: the share of the traced window in which the
card ran no kernel, copy or fill (one less the union of their intervals
over the window)."""


def read(w):
    trace = w.get("trace")
    if w.get("kind") != "train" or trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
