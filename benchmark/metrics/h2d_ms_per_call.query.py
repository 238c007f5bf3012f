"""h2d_ms_per_call.query: the device time of host-to-device copies in the
traced window, over the window's query calls."""


def read(w):
    trace = w.get("trace")
    if w.get("kind") != "query" or trace is None or not w.get("calls"):
        return None
    copies = [b - a for name, a, b in trace.copies if "HtoD" in name]
    if not copies:
        return None
    return sum(copies) / 1e3 / w["calls"]
