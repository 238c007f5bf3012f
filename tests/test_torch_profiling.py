"""Profiling hooks on the CPU: `trace` writes a Chrome trace holding the
`annotate` spans (also when the block raises); `StepTimer` gives the JAX
package's summary for the same clock readings (both modules' perf_counter
patched); `device_memory_stats` is {} with no card and keyed by card
with cards; `dump_profile` writes the JAX package's file."""
from __future__ import annotations

import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demovlp_tpu.utils import profiling as jprof
from demovlp_tpu_torch.utils import profiling as tprof


def _events(path):
    return json.loads(path.read_text())["traceEvents"]


def test_trace_holds_the_annotated_spans(tmp_path):
    x = torch.randn(8, 8)
    with tprof.trace(tmp_path, device="cpu") as prof:
        for name in ("data", "step"):
            with tprof.annotate(name):
                x = x @ x
    spans = [e["name"] for e in _events(tmp_path / tprof.TRACE_FILE)
             if e.get("cat") == "user_annotation"]
    assert spans == ["data", "step"]
    assert any("mm" in e.key for e in prof.key_averages())


def test_trace_is_written_when_the_block_raises(tmp_path):
    with pytest.raises(RuntimeError, match="boom"):
        with tprof.trace(tmp_path):
            with tprof.annotate("failing"):
                raise RuntimeError("boom")
    assert any(e.get("name") == "failing" for e in _events(tmp_path / tprof.TRACE_FILE))


def _readings(n, seed):
    t = np.cumsum(np.random.RandomState(seed).uniform(0.01, 0.2, n))
    return iter(t.tolist())


@pytest.mark.parametrize("warmup,steps", [(0, 1), (2, 2), (2, 3), (2, 11), (1, 25)])
def test_step_timer_summary_matches_jax(monkeypatch, warmup, steps):
    summaries = []
    for module, result in ((jprof, jnp.ones(3)), (tprof, {"loss": [torch.ones(3)]})):
        clock = _readings(steps, seed=steps)
        monkeypatch.setattr(module, "time", types.SimpleNamespace(perf_counter=lambda: next(clock)))
        timer = module.StepTimer(warmup=warmup)
        dts = [timer.observe(result) for _ in range(steps)]
        summaries.append((timer.summary(), dts))
    assert summaries[0] == summaries[1]


def test_dump_profile_matches_jax(tmp_path, monkeypatch):
    for module, sub in ((jprof, "jax"), (tprof, "port")):
        clock = _readings(6, seed=1)
        monkeypatch.setattr(module, "time", types.SimpleNamespace(perf_counter=lambda: next(clock)))
        timer = module.StepTimer()
        for _ in range(6):
            timer.observe()
        (tmp_path / sub).mkdir()
        module.dump_profile(tmp_path / sub, timer)
    assert (tmp_path / "jax" / "step_times.json").read_text() == \
        (tmp_path / "port" / "step_times.json").read_text()


def test_device_memory_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tprof.device_memory_stats() == {}


def test_device_memory_stats_by_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {"allocated_bytes.all.peak": 10 + i})
    assert tprof.device_memory_stats() == {"cuda:0": {"allocated_bytes.all.peak": 10},
                                           "cuda:1": {"allocated_bytes.all.peak": 11}}
