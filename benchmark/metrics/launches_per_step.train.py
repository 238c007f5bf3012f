"""launches_per_step.train: the CUDA kernels the device ran in the traced
window, over the window's steps."""


def read(w):
    trace = w.get("trace")
    if w.get("kind") != "train" or trace is None or not w.get("steps"):
        return None
    return len(trace.kernels) / w["steps"]
