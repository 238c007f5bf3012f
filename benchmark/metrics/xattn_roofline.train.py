"""xattn_roofline.train: the local-similarity kernels' share of their
roofline in the traced window (counts/xattn.py), over every kernel the
port's xattn launchers run: the row norms, the main kernels and the
backward's reduce."""
from benchmark.counts.xattn import roofline_share

PATTERNS = ("xattn_sim_", "l2norm_rows")


def read(w):
    if w.get("kind") != "train":
        return None
    return roofline_share(w, PATTERNS)
