"""The program's spans on the trace's clock (harness/program_spans.py), on a
hand-made trace and recorder: the pairing recovers the clocks' offset,
also where one edge of a pair waited, refuses pairs that disagree or are
missing, and the five readers give the
hand-computed values in their own kind of cell and nothing in the other."""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import pytest

from benchmark.harness import program_spans
from benchmark.harness.spec import Spec
from benchmark.harness.trace import Trace
from benchmark.tests.tiny import REPO

OFF = -5.0e6 + 0.25  # trace us = program us + OFF
MAIN, LOADER = 11, 22


class Span(NamedTuple):  # the program recorder's record
    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: int
    thread: int
    counters: Dict[str, float]


def _span(name, a, b, thread=MAIN, counters=None, shift=0.0):
    """A program span at trace times [a, b] us (plus `shift` us)."""
    return Span(name, round((a + shift - OFF) * 1e3), round((b + shift - OFF) * 1e3), -1, thread,
                counters or {})


def _train(shift_second=0.0):
    t = Trace(window=(0.0, 10000.0))
    t.kernels = [("k", 0.0, 600.0), ("k", 1200.0, 1800.0), ("k", 2600.0, 3000.0),
                 ("k", 4000.0, 5500.0), ("k", 9000.0, 10000.0)]
    t.host = [("bench.step_call", 1000.0, 4000.0), ("bench.step_call", 5000.0, 8000.0)]
    spans = [_span("train.upload", 500, 900, counters={"train.upload_bytes": 1000}),
             _span("train.step", 1010, 3990), _span("train.forward", 1100, 2000),
             _span("train.loss", 2000, 2500), _span("train.backward", 2500, 3500),
             _span("train.optimizer", 3500, 3900), _span("data.batch", 1500, 2500, LOADER),
             _span("train.upload", 4200, 4900, counters={"train.upload_bytes": 1000})]
    spans += [_span(n, a, b, shift=shift_second) for n, a, b in (
        ("train.step", 5010, 7990), ("train.forward", 5100, 6000), ("train.loss", 6000, 6500),
        ("train.backward", 6500, 7500), ("train.optimizer", 7500, 7900))]
    w = {"kind": "train", "steps": 2, "trace": t}
    return w, {"spans": spans, "counters": {}, "dropped": 0, "main_thread": MAIN}


def _query():
    t = Trace(window=(0.0, 10000.0))
    t.kernels = [("k", 0.0, 2500.0), ("k", 3000.0, 3100.0), ("k", 3600.0, 10000.0)]
    t.host = [("bench.sharded_local_sims", 2000.0, 6000.0)]
    spans = [_span("serve.local_sims", 2005, 5995),
             _span("serve.stage", 2010, 3010, counters={"serve.staged_bytes": 4000}),
             _span("serve.stage", 3010, 3510, counters={"serve.staged_bytes": 2000}),
             _span("serve.readback", 4000, 5990)]
    w = {"kind": "query", "calls": 1, "trace": t}
    return w, {"spans": spans, "counters": {}, "dropped": 0, "main_thread": MAIN}


def test_pairing_recovers_the_offset():
    w, rec = _train()
    placed = program_spans.place(w, rec)
    assert placed.pairs == 2
    assert abs(placed.offset_us - OFF) < 1.0 and placed.disagreement_us == 0.0
    step = placed.of("train.step")[0]
    assert step[1] == pytest.approx(1010.0, abs=1e-3) and step[2] == pytest.approx(3990.0,
                                                                                   abs=1e-3)


@pytest.mark.parametrize("case", ["disagree", "no_spans", "no_recorder", "counts_differ"])
def test_pairing_refuses(case):
    w, rec = _train(shift_second=200.0 if case == "disagree" else 0.0)
    if case == "no_spans":
        rec["spans"] = []
    elif case == "no_recorder":
        rec = {}
    elif case == "counts_differ":
        rec["spans"] = [s for s in rec["spans"] if s.start_ns != rec["spans"][1].start_ns]
    assert program_spans.place(w, rec) is None
    assert program_spans.ms_per(w, "train", "train.step", "steps", rec) is None
    assert program_spans.idle_share_inside(w, "train", "train.step", rec) is None


def test_a_small_disagreement_is_kept():
    # the second step's program spans 60 us late: its range [OFF - 70, OFF - 50]
    # misses the first's [OFF - 10, OFF + 10] by 40 us
    w, rec = _train(shift_second=60.0)
    placed = program_spans.place(w, rec)
    assert placed is not None and placed.disagreement_us == pytest.approx(40.0, abs=1e-3)


def test_a_wait_at_one_edge_moves_nothing():
    # the second step opens 2 ms late (a wait for the interpreter's lock): its
    # range widens on one side only, and the offset stays
    w, rec = _train()
    rec["spans"] = [s._replace(start_ns=s.start_ns + 2_000_000) if s.name == "train.step"
                    and s.start_ns > (5000 - OFF) * 1e3 else s for s in rec["spans"]]
    placed = program_spans.place(w, rec)
    assert abs(placed.offset_us - OFF) < 1.0 and placed.disagreement_us == 0.0


READS = {
    "upload_ms.train": ("train", (400 + 700) / 1e3 / 2),
    "dispatch_ms.train": ("train", 2 * 2980 / 1e3 / 2),
    # idle 600 + 800 + 1000 + 3500 us; inside train.step 190 + 800 + 990 + 2490
    "idle_in_dispatch_share.train": ("train", 100 * 4470 / 5900),
    "stage_ms_per_call.query": ("query", 1.5),
    # idle 500 + 500 us; inside serve.stage 500 + 410
    "idle_in_stage_share.query": ("query", 100 * 910 / 1000),
}


@pytest.mark.parametrize("metric", sorted(READS))
def test_readers(metric, monkeypatch):
    kind, want = READS[metric]
    windows = {"train": _train(), "query": _query()}
    reader = Spec(REPO).metric_reader(metric)
    for k, (w, rec) in windows.items():
        monkeypatch.setattr(program_spans, "recorded", lambda rec=rec: rec)
        got = reader.read(w)
        if k == kind:
            assert got == pytest.approx(want)
        else:
            assert got is None


def test_summary_names_all_idle_time():
    w, rec = _train()
    s = program_spans.summary(w, rec)
    assert sum(s["idle_by_innermost_ms"].values()) == pytest.approx(s["idle_ms"]) == 5.9
    # outside any span: [900, 1010], [3990, 4000], [7990, 9000]
    assert s["idle_by_innermost_ms"][program_spans.NO_SPAN] == pytest.approx(0.11 + 0.01 + 1.01)
    # train.step's own time: [1010, 1100], [3900, 3990], [7900, 7990]
    assert s["idle_by_innermost_ms"]["train.step"] == pytest.approx(3 * 0.09)
    assert s["staging"]["train.upload"]["bytes"] == 2000
    assert s["overlapped_by_data_batch"] == {"train.step": pytest.approx(1000 / 5960),
                                             "train.upload": 0.0}
    assert s["spans"]["data.batch (other thread)"] == {"count": 1, "ms": pytest.approx(1.0)}
