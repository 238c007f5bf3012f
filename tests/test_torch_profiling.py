"""Profiling hooks on the CPU: `span` and `count` record nothing and make
no `record_function` call with no profiler session; under a session they
keep each span's parent, thread and counters, close a span the block
raised in, drop and count spans beyond the bound; `trace` writes a Chrome
trace holding the spans as `user_annotation` events and `spans.json`
beside it (also when the block raises); the train step, the batch upload,
the deferred loss read, the loader and the query path record their spans
and byte counters; `device_memory_stats` is {} with no card and keyed by
card with cards."""
from __future__ import annotations

import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from demovlp_tpu_torch import serve
from demovlp_tpu_torch.cli import common
from demovlp_tpu_torch.data.tokenizer import SimpleTokenizer
from demovlp_tpu_torch.parallel.sharded_eval import sharded_local_sims
from demovlp_tpu_torch.train.async_metrics import DeferredMetrics
from demovlp_tpu_torch.train.steps import (batch_to_device, make_retrieval_train_step,
                                           prepare_batch)
from demovlp_tpu_torch.utils import profiling as tprof

SMOKE = Path(__file__).resolve().parents[1] / "configs" / "smoke" / "synthetic_retrieval.json"
STEP_CHILDREN = ["train.forward", "train.loss", "train.backward", "train.optimizer"]


def _events(path):
    return json.loads(path.read_text())["traceEvents"]


@pytest.fixture
def session():
    """A CPU profiler session over the test, the recorder emptied first."""
    tprof.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        yield
    assert not tprof.recording()


def _spans():
    return tprof.recorded()["spans"]


def _by_name(spans, name):
    return [i for i, s in enumerate(spans) if s.name == name]


def test_span_without_a_session_records_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError("record_function called with no session")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    tprof.clear()
    assert not tprof.recording()
    with tprof.span("outer"):
        with tprof.span("inner"):
            tprof.count("bytes", 3)
    rec = tprof.recorded()
    assert rec["spans"] == [] and rec["counters"] == {} and rec["dropped"] == 0


def test_span_without_a_session_allocates_nothing():
    # one shared no-op context: nothing is made a call
    assert tprof.span("a") is tprof.span("b")
    assert type(tprof.span("a")).__slots__ == ()


def test_spans_nest_with_their_parents(session):
    with tprof.span("a"):
        with tprof.span("b"):
            with tprof.span("c"):
                pass
        with tprof.span("d"):
            pass
    with tprof.span("e"):
        pass
    spans = _spans()
    assert [s.name for s in spans] == ["a", "b", "c", "d", "e"]
    assert [s.parent for s in spans] == [-1, 0, 1, 0, -1]
    for s in spans:
        assert s.start_ns <= s.end_ns
        assert s.thread == threading.get_ident()
    a, b, c, d, _ = spans
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= d.start_ns
    assert d.end_ns <= a.end_ns


def test_spans_keep_their_thread(session):
    def worker():
        with tprof.span("worker"):
            with tprof.span("worker.inner"):
                pass

    with tprof.span("main"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    spans = _spans()
    main, worker_span, inner = (spans[_by_name(spans, n)[0]]
                                for n in ("main", "worker", "worker.inner"))
    # the worker's span opened while "main" was open, on another thread: a root
    assert worker_span.parent == -1 and worker_span.thread != main.thread
    assert inner.parent == _by_name(spans, "worker")[0] and inner.thread == worker_span.thread
    assert main.thread == tprof.recorded()["main_thread"] == threading.get_ident()


def test_counters_go_to_the_innermost_span(session):
    tprof.count("loose", 2)
    with tprof.span("outer"):
        tprof.count("bytes", 5)
        with tprof.span("inner"):
            tprof.count("bytes", 7)
            tprof.count("bytes", 1)
            tprof.count("rows", 4)
    rec = tprof.recorded()
    outer, inner = rec["spans"]
    assert outer.counters == {"bytes": 5}
    assert inner.counters == {"bytes": 8, "rows": 4}
    assert rec["counters"] == {"loose": 2, "bytes": 13, "rows": 4}


def test_a_span_closes_when_its_block_raises(session):
    with pytest.raises(ValueError, match="boom"):
        with tprof.span("outer"):
            with tprof.span("failing"):
                raise ValueError("boom")
    with tprof.span("after"):
        pass
    spans = _spans()
    assert [(s.name, s.parent) for s in spans] == [("outer", -1), ("failing", 0), ("after", -1)]
    assert all(s.end_ns is not None for s in spans)


def test_spans_beyond_the_bound_are_dropped_and_counted(session, monkeypatch):
    monkeypatch.setattr(tprof._RECORDER, "limit", 3)
    with tprof.span("kept"):
        for i in range(4):
            with tprof.span(f"child{i}"):
                tprof.count("n", 1)
    rec = tprof.recorded()
    assert [s.name for s in rec["spans"]] == ["kept", "child0", "child1"]
    assert rec["dropped"] == 2
    # a dropped span's count still reaches the total
    assert rec["counters"] == {"n": 4}
    tprof.clear()
    assert tprof.recorded()["dropped"] == 0


def test_a_span_open_across_a_clear_is_no_parent(session):
    with tprof.span("before"):
        tprof.clear()
        with tprof.span("after"):
            pass
    spans = _spans()
    assert [(s.name, s.parent) for s in spans] == [("after", -1)]


def test_trace_holds_the_annotated_spans(tmp_path):
    x = torch.randn(8, 8)
    with tprof.span("outside"):  # no session: not recorded
        pass
    with tprof.trace(tmp_path, device="cpu") as prof:
        for name in ("data", "step"):
            with tprof.span(name):
                with tprof.span(f"{name}.inner"):
                    x = x @ x
    names = [e["name"] for e in sorted(_events(tmp_path / tprof.TRACE_FILE),
                                       key=lambda e: e.get("ts", 0))
             if e.get("cat") == "user_annotation"]
    assert names == ["data", "data.inner", "step", "step.inner"]
    written = json.loads((tmp_path / tprof.SPANS_FILE).read_text())
    assert [s["name"] for s in written["spans"]] == names
    assert [s["parent"] for s in written["spans"]] == [-1, 0, -1, 2]
    assert any("mm" in e.key for e in prof.key_averages())


def test_trace_is_written_when_the_block_raises(tmp_path):
    with pytest.raises(RuntimeError, match="boom"):
        with tprof.trace(tmp_path):
            with tprof.span("failing"):
                raise RuntimeError("boom")
    assert any(e.get("name") == "failing" for e in _events(tmp_path / tprof.TRACE_FILE))
    written = json.loads((tmp_path / tprof.SPANS_FILE).read_text())
    assert [s["name"] for s in written["spans"]] == ["failing"]


@pytest.fixture(scope="module")
def smoke():
    cfg = json.loads(SMOKE.read_text())
    torch.manual_seed(0)
    model = common.build_model(cfg)
    dl = common.init_dataloaders(cfg, val_split="test")[0][0]
    dl.set_epoch(1)
    it = iter(dl)
    data = next(it)
    it.close()
    return {"cfg": cfg, "model": model, "data": data, "loader": dl}


def test_train_step_records_its_pieces(session, smoke):
    cfg, model = smoke["cfg"], smoke["model"]
    step = make_retrieval_train_step(model, common.build_loss(cfg),
                                     common.build_optimizer(cfg, model.parameters()),
                                     deterministic=True)
    # four rows, text trimmed to its bucket: a step of a fraction of a second
    data = {k: v[:4] for k, v in smoke["data"].items()}
    arrays = prepare_batch(data, SimpleTokenizer(), text_buckets=[8, 12, 16])
    batch = batch_to_device(arrays, torch.device("cpu"))
    step(batch, 1e-4)
    spans = _spans()
    (up,) = _by_name(spans, "train.upload")
    assert spans[up].counters == {"train.upload_bytes": sum(t.nbytes for t in batch.values())}
    assert spans[up].counters["train.upload_bytes"] > batch["object"].nbytes
    (st,) = _by_name(spans, "train.step")
    assert spans[st].parent == -1
    children = [s.name for s in spans if s.parent == st]
    assert children == STEP_CHILDREN
    for i in _by_name(spans, "train.backward") + _by_name(spans, "train.forward"):
        assert spans[st].start_ns <= spans[i].start_ns <= spans[i].end_ns <= spans[st].end_ns


def test_deferred_metrics_read_inside_their_span(session):
    reads = []
    deferred = DeferredMetrics(lambda m: (tprof.count("read", 1), reads.append(m)))
    deferred.push(1)
    assert _spans() == []  # nothing to read yet
    deferred.push(2)
    deferred.flush()
    spans = _spans()
    assert reads == [1, 2]
    assert [(s.name, s.counters) for s in spans] == [("train.read_metrics", {"read": 1})] * 2


def test_loader_waits_and_batches_are_spans(session, smoke):
    it = iter(smoke["loader"])
    try:
        for _ in range(2):
            next(it)
    finally:
        it.close()
    spans = _spans()
    main = threading.get_ident()
    waits = [spans[i] for i in _by_name(spans, "data.wait")]
    batches = [spans[i] for i in _by_name(spans, "data.batch")]
    assert len(waits) == 2 and all(s.thread == main and s.parent == -1 for s in waits)
    assert len(batches) >= 2 and all(s.thread != main for s in batches)


def test_query_records_the_serving_spans(session, smoke):
    model = smoke["model"]
    step = serve.make_text_embed_step(model)
    rng = np.random.default_rng(0)
    n, regions, d = 5, 8, model.object_model.proj.out_features
    index = {"g_o": rng.standard_normal((n, d), np.float32),
             "l_o": rng.standard_normal((n, regions, d), np.float32),
             "o_mask": np.zeros((n, regions), np.float32)}
    queries = ["a dog runs", "red car", "people talk"]
    results, sims = serve.query_retrieval(step, queries, SimpleTokenizer(), index, "cpu", k=2)
    assert len(results) == 3 and sims.shape == (3, n)
    spans = _spans()
    (query,) = _by_name(spans, "serve.query")
    inside = [s.name for s in spans if s.parent == query]
    assert inside == ["serve.embed_texts", "serve.global_sims", "serve.local_sims", "serve.topk"]
    (local,) = _by_name(spans, "serve.local_sims")
    assert [s.name for s in spans if s.parent == local] == ["serve.stage", "serve.stage",
                                                            "serve.readback"]
    # the queries' local embeddings and mask at the 99 text positions after CLS
    want = len(queries) * 99 * (d + 1) * 4 + index["l_o"].nbytes + index["o_mask"].nbytes
    assert tprof.recorded()["counters"] == {"serve.staged_bytes": want}


def test_staged_bytes_count_the_padded_chunks(session):
    rng = np.random.default_rng(1)
    img, cap = rng.standard_normal((5, 4, 8), np.float32), rng.standard_normal((3, 6, 8),
                                                                                np.float32)
    sims = sharded_local_sims(img, cap, np.zeros((5, 4), np.float32),
                              np.zeros((3, 6), np.float32), device="cpu", chunk_rows=3)
    assert sims.shape == (5, 3)
    spans = _spans()
    stages = [spans[i] for i in _by_name(spans, "serve.stage")]
    # the caption block, then two gallery chunks of 3 rows (the second padded)
    per_chunk = 3 * 4 * 8 * 4 + 3 * 4 * 4
    assert [s.counters["serve.staged_bytes"] for s in stages] == [3 * 6 * 8 * 4 + 3 * 6 * 4,
                                                                  per_chunk, per_chunk]
    assert len(_by_name(spans, "serve.readback")) == 2


def test_device_memory_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tprof.device_memory_stats() == {}


def test_device_memory_stats_by_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {"allocated_bytes.all.peak": 10 + i})
    assert tprof.device_memory_stats() == {"cuda:0": {"allocated_bytes.all.peak": 10},
                                           "cuda:1": {"allocated_bytes.all.peak": 11}}
