"""The trace's reduction (busy share, idle gaps, breakdown) and the
per-layer readers, on hand-made events; the roofline reader refuses a
trace that hides the kernels the program counted."""
from __future__ import annotations

import pytest

from benchmark.harness.spec import Spec
from benchmark.harness.trace import Trace, breakdown
from benchmark.tests.tiny import REPO

H100 = "NVIDIA H100 80GB HBM3"


def _trace():
    t = Trace(window=(0.0, 1000.0))
    t.kernels = [("xattn_sim_fwd_bf16_kernel", 100.0, 300.0), ("gemm", 250.0, 400.0),
                 ("l2norm_rows_bf16_kernel", 700.0, 800.0)]
    t.copies = [("Memcpy HtoD (Pinned -> Device)", 900.0, 950.0)]
    t.host = [("bench.data_wait", 420.0, 690.0), ("cudaStreamSynchronize", 0.0, 99.0)]
    return t


def test_busy_and_gaps():
    t = _trace()
    assert t.busy_s == pytest.approx((300 + 100 + 50) / 1e6)
    assert t.window_s == pytest.approx(1e-3)
    gaps = t.idle_gaps()
    assert gaps[0][:1] == (300.0,) and gaps[0][1:] == (400.0, 700.0)
    parts = breakdown(t)
    assert parts["idle_gaps"][0][0] == "bench.data_wait"
    assert parts["device_ops"][0][0] == "xattn_sim_fwd_bf16_kernel"
    assert len(parts["device_ops"]) <= 10 and len(parts["idle_gaps"]) <= 10


def _window(trace, launches):
    return {"kind": "train", "steps": 2, "window_s": 1e-3, "trace": trace,
            "xattn_launches": launches, "xattn_items": lambda ls, lq: (128, 128), "d": 256,
            "local_precision": "bfloat16", "flops_per_step": 5.728e12, "device_name": H100,
            "data_waits_s": [0.001, 0.003]}


def test_readers():
    spec = Spec(REPO)
    w = _window(_trace(), {("xattn_sim_fwd_bf16", 30, 99): 1})
    read = {m.name: spec.metric_reader(m.name).read(w) for m in spec.per_layer_of("pt_cc_f1")}
    assert read["data_wait_ms.train"] == pytest.approx(2.0)
    assert read["launches_per_step.train"] == pytest.approx(1.5)
    assert read["device_idle_share.train"] == pytest.approx(55.0)
    # one forward launch at (30, 99): 4 * 128 * 128 * 99 * 30 * 256 FLOP at 989e12
    bound = 4 * 128 * 128 * 99 * 30 * 256 / 989e12
    assert read["xattn_roofline.train"] == pytest.approx(100 * bound / 300e-6)
    assert read["mfu.train"] == pytest.approx(100 * 5.728e12 * 2 / 1e-3 / 989e12)
    assert spec.metric_reader("h2d_ms_per_call.query").read(w) is None


def test_hidden_kernels_fail_the_traced_run():
    t = _trace()
    t.kernels = [k for k in t.kernels if k[0] == "gemm"]
    w = _window(t, {("xattn_sim_fwd_bf16", 30, 99): 4})
    with pytest.raises(RuntimeError, match="none of their kernels"):
        Spec(REPO).metric_reader("xattn_roofline.train").read(w)


def test_unknown_card_reads_nothing():
    w = _window(_trace(), {("xattn_sim_fwd_bf16", 30, 99): 1})
    w["device_name"] = "cpu"
    spec = Spec(REPO)
    for name in ("mfu.train", "xattn_roofline.train"):
        assert spec.metric_reader(name).read(w) is None
