"""The pixel cell (`ft_msrvtt_frozen4f`, driver `train_frames`) on the CPU:
the spec resolves it and its readers, a tiny float32 run of the driver is
correct against the reference, its control and planted fault are not,
the frozen FLOP model agrees with a count of the reference's products,
and `video_attn_share.train` reads the hand-computed share of a hand-made
trace (nothing where the program has no attention span)."""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import control_frozen
from benchmark.counts import frozen_flops
from benchmark.harness import program_spans
from benchmark.harness.spec import Spec
from benchmark.harness.trace import Trace
from benchmark.reference import frozen
from benchmark.tests.frames_tiny import make_root
from benchmark.tests.tiny import REPO, run_cell

CELL = "ft_msrvtt_frozen4f"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("frames"))


def test_spec_resolves_the_cell():
    spec = Spec(REPO)
    cell = spec.cell(CELL)
    assert cell.chips == 1
    config, traffic = spec.config(cell.config), spec.traffic(cell.traffic)
    assert traffic["driver"] == "train_frames" and spec.driver("train_frames").run
    w = frozen.Widths.from_config(config["program"])
    assert (w.frames, w.resolution, w.patch, w.dim, w.depth, w.heads) == (4, 224, 16, 768, 12, 12)
    layer = {m.name for m in spec.per_layer_of(CELL)}
    assert "video_attn_share.train" in layer and "xattn_roofline.train" not in layer
    assert {m.name for m in spec.end_to_end_of(CELL)} == {"train_samples_per_s", "setup_s"}


def test_tiny_run_is_correct(root):
    rc, result, err = run_cell(root, "frozen", seconds=1)
    assert rc == 0, err[-2000:]
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "update_gap"}


@pytest.mark.parametrize("variant", ["control", "half_batch"])
def test_control_and_fault_fail(tmp_path, variant):
    root = make_root(tmp_path)
    # at the configuration's own precision, as the cell runs
    path = root / "benchmark" / "configs" / "tiny_frozen.json"
    text = path.read_text().replace('"compute": "float32"', '"compute": "bfloat16"')
    path.write_text(text)
    lines = control_frozen.main(["--workload", "frozen", "--seeds", "3", "4",
                                 "--variant", variant], root=root, device="cpu")
    assert lines and all(line["correct"] is False and line["failed"] for line in lines), lines


def test_flop_model_counts_the_reference_products():
    w = frozen.Widths(vocab=1000, text_dim=32, text_layers=2, text_heads=2, text_hidden=128,
                      max_positions=32, frames=3, resolution=48, patch=16, dim=32, depth=2,
                      heads=2, proj=16)
    P = {n: torch.randn(s) * 0.02 for n, s in frozen.param_shapes(w).items()}
    b, length = 2, 10
    batch = {"input_ids": torch.randint(1000, (b, length)),
             "attention_mask": torch.ones(b, length, dtype=torch.long),
             "video": torch.randint(0, 256, (b, 3, 3, 48, 48), dtype=torch.uint8)}
    with FlopCounterMode(display=False) as counter:
        frozen.video_tower(P, w, batch["video"])
    video = counter.get_total_flops()
    with FlopCounterMode(display=False) as counter:
        frozen.text_tower(P, w, batch["input_ids"], batch["attention_mask"])
    text = counter.get_total_flops()
    assert video == b * frozen_flops.video_forward(3, 9, 16, 32, 2, 16)
    assert text == b * frozen_flops.text_forward(length, 32, 2, 16)
    assert frozen_flops.step(b, 3, 9, length, 16, 32, 2, 32, 2, 16) == pytest.approx(
        3 * (video + text) + 3 * 2 * b * b * 16)


MAIN, AUTOGRAD = 11, 33


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: int
    thread: int
    counters: Dict[str, float]


def _window(with_attention=True):
    t = Trace(window=(0.0, 10000.0))
    # (name, start, end) on the card; launched at the host times below
    launches = [("gemm", 100.0, 1100.0, 50.0), ("copy", 1200.0, 1700.0, 1050.0),
                ("gemm", 2000.0, 3000.0, 1500.0), ("nccl", 3000.0, 3500.0, 2600.0),
                ("gemm", 5000.0, 6000.0, 4100.0)]
    t.kernels = [(n, a, b) for n, a, b, _ in launches]
    t.host = [("bench.step_call", 0.0, 5000.0)]
    spans = [Span("train.step", 10_000, 4_990_000, -1, MAIN, {})]
    if with_attention:  # the forward's span on the main thread, the backward's elsewhere
        spans += [Span("video.time_attn", 1_000_000, 1_200_000, 0, MAIN, {}),
                  Span("video.space_attn", 1_400_000, 2_000_000, 0, MAIN, {}),
                  Span("video.space_attn", 4_000_000, 4_500_000, -1, AUTOGRAD, {})]
    w = {"kind": "train", "steps": 1, "trace": t, "launches": launches}
    w["_program_spans"] = program_spans.place(
        w, {"spans": spans, "counters": {}, "dropped": 0, "main_thread": MAIN})
    return w


def test_video_attn_share_on_a_hand_made_trace():
    read = Spec(REPO).metric_reader("video_attn_share.train").read
    w = _window()
    # busy 1000 + 500 + 1000 + 500 + 1000 us; inside a span at launch: copy (1050),
    # gemm (1500) and the backward's gemm (4100): 500 + 1000 + 1000 us
    assert w["trace"].busy_s == pytest.approx(4000e-6)
    assert read(w) == pytest.approx(100.0 * 2500 / 4000)
    assert read(_window(with_attention=False)) is None
    assert read({"kind": "train", "trace": w["trace"]}) is None  # no launches kept
