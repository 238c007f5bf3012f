"""Published peaks of the cards the benchmark runs on (NVIDIA's H100 data
sheet, SXM part, dense rates without sparsity, at the full 700 W), and the
least time an amount of work can take on one of them."""
from __future__ import annotations

from typing import Dict, Optional

PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "tf32": 495e12, "f32": 67e12, "bytes": 3.35e12},
}
#: a float32 product on the tensor cores is three TF32 passes (3xTF32)
TF32_PASSES = 3


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    for prefix, p in PEAKS.items():
        if device_name.startswith(prefix):
            return p
    return None


def product_rate(p: Dict[str, float], precision: str) -> float:
    """FLOP/s of a product in the stated precision: bf16 at the bf16 peak,
    float32 as TF32_PASSES TF32 passes."""
    if precision == "bfloat16":
        return p["bf16"]
    if precision == "float32":
        return p["tf32"] / TF32_PASSES
    raise ValueError(f"no peak for precision {precision!r}")


def bound_s(p: Dict[str, float], flops: float, nbytes: float, precision: str) -> float:
    """The larger of the operations at the product rate and the bytes at the
    memory bandwidth."""
    return max(flops / product_rate(p, precision), nbytes / p["bytes"])
