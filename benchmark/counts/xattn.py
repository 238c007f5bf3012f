"""The local-similarity kernels' share of their roofline over a window:
the least time the launches counted in it could take (their shapes, the
configuration's stated precision, the card's published peaks) over the
device time the trace gives the kernels whose names match."""
from __future__ import annotations

from typing import Optional, Sequence

from benchmark.counts import flops, peaks

#: the port's launch counter names -> the kernel whose work they count
COUNTED = {"xattn_sim_fwd": "fwd", "xattn_sim_fwd_bf16": "fwd",
           "xattn_sim_bwd_dq": "dq", "xattn_sim_bwd_dc": "dc"}


def roofline_share(w: dict, patterns: Sequence[str]) -> Optional[float]:
    """Percent; None where the window counted no launch or the card has no
    published peaks. Raises where launches were counted but the trace
    shows none of the kernels (a trace that hides the port's kernels)."""
    trace, launches = w.get("trace"), w.get("xattn_launches") or {}
    if trace is None or not launches:
        return None
    p = peaks.peaks(w["device_name"])
    if p is None:
        return None
    bound = 0.0
    for (name, ls, lq), count in launches.items():
        bc, bq = w["xattn_items"](ls, lq)
        work = flops.xattn_work(COUNTED[name], bc, bq, ls, lq, w["d"])
        bound += count * peaks.bound_s(p, work["flops"], work["bytes"], w["local_precision"])
    seen = sum(b - a for name, a, b in trace.kernels if any(s in name for s in patterns)) / 1e6
    if seen <= 0:
        raise RuntimeError(f"{sum(launches.values())} local-similarity launches were counted in "
                           "the traced window, but the trace holds none of their kernels")
    return 100.0 * bound / seen
