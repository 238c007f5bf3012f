"""tiny.make_root builds its scratch checkout from the repository's
BENCHMARK.json and maps the names of the first three cells only; a cell
added since (pt_cc_f1_dp4, ft_msrvtt_frozen4f) in a metric's list would
make it raise. Until tiny.py filters those itself, the tests that use it
are handed a make_root that reads a BENCHMARK.json whose lists hold the
first three cells alone (frames_tiny.py builds the checkout of the later
cells)."""
from __future__ import annotations

import json
import tempfile
from pathlib import Path

from benchmark.tests import tiny

FIRST_CELLS = ("pt_cc_f1", "ft_msrvtt_f8", "query_1k_f8")
_make_root = tiny.make_root


def _make_root_of_first_cells(tmp: Path, precision: str = "configured") -> Path:
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w in FIRST_CELLS]
    with tempfile.TemporaryDirectory(prefix="bench_first_cells_") as d:
        (Path(d) / "BENCHMARK.json").write_text(json.dumps(bench))
        repo, tiny.REPO = tiny.REPO, Path(d)
        try:
            return _make_root(tmp, precision)
        finally:
            tiny.REPO = repo


tiny.make_root = _make_root_of_first_cells
