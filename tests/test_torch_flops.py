"""The FLOP model and MFU: the analytic step model equals the JAX
package's exactly; FlopCounterMode's count of a Linear is 2 m n k forward
and 6 m n k with its backward; the bf16 peak is the H100 SXM part's 989
TFLOP/s by device name and None for the CPU and for other names, and MFU
is None where the peak is."""
from __future__ import annotations

import pytest
import torch

from demovlp_tpu.utils import flops as jflops
from demovlp_tpu_torch.utils import flops


@pytest.mark.parametrize("global_b,frames,regions,text_len,use_local", [
    (128, 1, 30, 100, True),
    (128, 1, 30, 32, True),
    (32, 8, 30, 100, True),
    (64, 8, 30, 100, False),
    (3, 2, 7, 11, True),
])
def test_step_model_matches_jax(global_b, frames, regions, text_len, use_local):
    args = (global_b, frames, regions, text_len)
    assert flops.retrieval_step_flops_model(*args, use_local=use_local) == \
        jflops.retrieval_step_flops_model(*args, use_local=use_local)
    narrow = dict(proj_dim=16, obj_depth=2, obj_dim=32, text_layers=2, text_dim=48)
    assert flops.retrieval_step_flops_model(*args, use_local=use_local, **narrow) == \
        jflops.retrieval_step_flops_model(*args, use_local=use_local, **narrow)
    assert flops._transformer_tower_flops(text_len, 64, 256, 3) == \
        jflops._transformer_tower_flops(text_len, 64, 256, 3)


@pytest.mark.parametrize("m,n,k", [(4, 8, 16), (33, 7, 5)])
def test_step_flops_of_a_linear(m, n, k):
    lin = torch.nn.Linear(k, n, bias=False)
    x = torch.randn(m, k, requires_grad=True)
    assert flops.step_flops(lin, x) == 2 * m * n * k

    def fwd_bwd():
        lin(x).sum().backward()

    assert flops.step_flops(fwd_bwd) == 6 * m * n * k


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12),
    ("NVIDIA H100 PCIe", None),
    ("NVIDIA A100-SXM4-80GB", None),
])
def test_peak_and_mfu_by_device_name(monkeypatch, name, peak):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    assert flops.peak_bf16_flops("cuda") == peak
    assert flops.peak_bf16_flops(torch.device("cuda", 0)) == peak
    got = flops.mfu(494.5e12, "cuda")
    assert got == (None if peak is None else 494.5e12 / peak)


def test_cpu_has_no_peak_and_no_mfu():
    assert flops.peak_bf16_flops("cpu") is None
    assert flops.mfu(1e12, torch.device("cpu")) is None
