"""nccl_ms_per_step.train: the device time of NCCL's kernels (the row
gathers and the gradient all-reduce of parallel/mesh.py) on rank 0 in the
traced window, over the window's steps. Nothing where the window ran no
NCCL kernel (one card)."""


def read(w):
    trace = w.get("trace")
    if w.get("kind") != "train" or trace is None or not w.get("steps"):
        return None
    nccl = [(a, b) for name, a, b in trace.kernels if "nccl" in name.lower()]
    if not nccl:
        return None
    return sum(b - a for a, b in nccl) / 1e3 / w["steps"]
