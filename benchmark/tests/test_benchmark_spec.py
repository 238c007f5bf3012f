"""The harness finds configurations, traffic, drivers and metrics by file
name, and a cell or metric added as new files plus BENCHMARK.json entries
is picked up."""
from __future__ import annotations

import json
import shutil

import pytest

from benchmark.harness.spec import Spec
from benchmark.tests.tiny import REPO, make_root, run_cell


def test_committed_cells_resolve():
    spec = Spec(REPO)
    for cell in spec.cells.values():
        config, traffic = spec.config(cell.config), spec.traffic(cell.traffic)
        assert "program" in config and "source" in config
        assert spec.driver(traffic["driver"]).run
        e2e = {m.name for m in spec.end_to_end_of(cell.name)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = spec.per_layer_of(cell.name)
        assert layer, cell.name
        for m in layer:
            assert m.moves in e2e
            assert callable(spec.metric_reader(m.name).read)


def test_missing_file_is_named(tmp_path):
    root = make_root(tmp_path)
    (root / "benchmark" / "traffic" / "tiny_pt_cc_f1.json").unlink()
    with pytest.raises(FileNotFoundError, match="tiny_pt_cc_f1"):
        Spec(root).traffic("tiny_pt_cc_f1")


def test_new_cell_and_metric_from_new_files_only(tmp_path):
    root = make_root(tmp_path, "float32")
    bench_dir = root / "benchmark"
    # a new traffic file and a new per-layer metric file, no edit of a file that is there
    t = json.loads((bench_dir / "traffic" / "tiny_pt_cc_f1.json").read_text())
    t["samples_per_epoch"] = 2048
    (bench_dir / "traffic" / "tiny_pt_small.json").write_text(json.dumps(t))
    (bench_dir / "metrics" / "steps_seen.train.py").write_text(
        "def read(w):\n    return w.get('steps') if w.get('kind') == 'train' else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "pt_small", "config": "tiny_demovlp_pt_f1",
                               "traffic": "tiny_pt_small", "chips": 1, "why": "added cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].append("pt_small")
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "Trainer dispatch",
                               "moves": "train_samples_per_s", "workloads": ["pt_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec(root)
    assert "steps_seen.train" in {m.name for m in spec.per_layer_of("pt_small")}
    assert spec.metric_reader("steps_seen.train").read({"kind": "train", "steps": 7}) == 7
    rc, result, _ = run_cell(root, "pt_small", seconds=1)
    assert rc == 0 and result["correct"] is True
    assert set(result["metrics"]) == {"train_samples_per_s", "setup_s"}


def test_result_line_keys(tmp_path):
    root = make_root(tmp_path, "float32")
    rc, result, err = run_cell(root, "query", seconds=1)
    assert rc == 0
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"queries_per_s", "setup_s"}
    last = err.strip().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("[check] ") and " limit " in line for line in last)
    shutil.rmtree(root)
