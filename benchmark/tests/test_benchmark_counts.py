"""The frozen FLOP model and kernel bounds give the bounds recorded for
the port's kernels at their main-path shapes (PERF.md's kernel table:
bf16 at 989 TFLOP/s, float32 as three TF32 passes at 495, bytes at
3.35 TB/s; both directions of a step summed)."""
from __future__ import annotations

import pytest

from benchmark.counts import flops, peaks

H100 = peaks.peaks("NVIDIA H100 80GB HBM3")


def step_bound_ms(name, bc, bq, ls, lq, d, precision):
    """Both directions of one step: (Ls, Lq) and (Lq, Ls)."""
    total = 0.0
    for a, b in ((ls, lq), (lq, ls)):
        w = flops.xattn_work(name, bc, bq, a, b, d)
        total += peaks.bound_s(H100, w["flops"], w["bytes"], precision)
    return 1e3 * total


@pytest.mark.parametrize("name,bc,bq,ls,lq,precision,want_ms", [
    ("fwd", 128, 128, 30, 99, "bfloat16", 0.101),
    ("dq", 128, 128, 30, 99, "bfloat16", 0.202),
    ("dc", 128, 128, 30, 99, "bfloat16", 0.101),
    ("fwd", 128, 128, 30, 31, "bfloat16", 0.0316),
    ("fwd", 32, 32, 240, 99, "float32", 0.302),
    ("dq", 32, 32, 240, 99, "float32", 0.604),
    ("dc", 32, 32, 240, 99, "float32", 0.302),
])
def test_step_bounds(name, bc, bq, ls, lq, precision, want_ms):
    assert step_bound_ms(name, bc, bq, ls, lq, 256, precision) == pytest.approx(want_ms, rel=5e-3)


@pytest.mark.parametrize("bq,want_ms", [(64, 18.87), (1000, 294.9)])
def test_serving_bounds(bq, want_ms):
    """A query call (1000 videos x 64 queries) and a whole serve (1000 x
    1000), the float32 forward of both directions."""
    total = 0.0
    for bc_, bq_, ls, lq in ((1000, bq, 240, 99), (bq, 1000, 99, 240)):
        w = flops.xattn_work("fwd", bc_, bq_, ls, lq, 256)
        total += peaks.bound_s(H100, w["flops"], w["bytes"], "float32")
    assert 1e3 * total == pytest.approx(want_ms, rel=5e-3)


def test_step_flop_model():
    """5.728e12 FLOP a pre-training step (the figure MFU was read against
    since the FLOP model was written), and the f = 8 fine-tune's."""
    assert flops.retrieval_step(128, 1, 30, 100) == pytest.approx(5.728e12, rel=1e-3)
    assert flops.retrieval_step(32, 8, 30, 100) == pytest.approx(5.2041e12, rel=1e-4)


def test_unknown_card_has_no_peaks():
    assert peaks.peaks("NVIDIA A100-SXM4-80GB") is None
    with pytest.raises(ValueError):
        flops.xattn_work("bwd", 1, 1, 1, 1, 4)
