"""Each cell's controls (the reference in the program's place, its towers
and local stage one precision step below the configuration's, or its local
stage alone) and planted faults come out not correct against the committed
limits, judged as a run is, on the CPU at a tiny size."""
from __future__ import annotations

import pytest

from benchmark import control
from benchmark.tests.tiny import make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("control"))


@pytest.mark.parametrize("cell,variant", [("pt", "control"), ("ft", "control"),
                                          ("pt", "control_local"), ("ft", "control_local"),
                                          ("pt", "half_batch"), ("ft", "half_batch"),
                                          ("query", "control"), ("query", "control_local"),
                                          ("query", "answer_altered")])
def test_control_fails(root, cell, variant):
    lines = control.main(["--workload", cell, "--seeds", "3", "4", "--variant", variant],
                         root=root, device="cpu")
    assert lines and all(line["correct"] is False and line["failed"] for line in lines), lines
