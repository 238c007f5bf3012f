"""The benchmark's data, found by name.

`BENCHMARK.json` at the checkout's root names each cell (workload), its
configuration and its traffic; everything that belongs to one of them sits
in a file of its own, found by that name:

  benchmark/configs/<config>.json    the program's configuration and its source
  benchmark/traffic/<traffic>.json   the traffic's parameters, naming a driver
  benchmark/drivers/<driver>.py      one per kind of traffic (train, query)
  benchmark/metrics/<metric>.py      one reader per per-layer metric

A later cell or metric is new files plus an entry in `BENCHMARK.json`.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

PACKAGE = "benchmark"


@dataclass
class Metric:
    name: str
    unit: str
    moves: Optional[str]
    workloads: Optional[List[str]]


@dataclass
class Cell:
    name: str
    config: str
    traffic: str
    chips: int


class Spec:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.cells = {w["name"]: Cell(w["name"], w["config"], w["traffic"], int(w["chips"]))
                      for w in self.bench["workloads"]}
        self.end_to_end = [self._metric(m) for m in self.bench["end_to_end"]]
        self.per_layer = [self._metric(m) for m in self.bench["per_layer"]]

    @staticmethod
    def _metric(m: Dict[str, Any]) -> Metric:
        return Metric(m["name"], m["unit"], m.get("moves"), m.get("workloads"))

    def cell(self, name: str) -> Cell:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(self.cells)}")
        return self.cells[name]

    def end_to_end_of(self, cell: str) -> List[Metric]:
        return [m for m in self.end_to_end if m.workloads is None or cell in m.workloads]

    def per_layer_of(self, cell: str) -> List[Metric]:
        """The per-layer metrics a traced run of `cell` reports: those that
        list it, and those without a list whose end-to-end metric it
        reports."""
        e2e = {m.name for m in self.end_to_end_of(cell)}
        return [m for m in self.per_layer
                if (cell in m.workloads if m.workloads is not None else m.moves in e2e)]

    def _file(self, kind: str, name: str, suffix: str) -> Path:
        path = self.root / PACKAGE / kind / f"{name}{suffix}"
        if not path.is_file():
            raise FileNotFoundError(f"{kind[:-1] if kind.endswith('s') else kind} {name!r}: "
                                    f"no file {path}")
        return path

    def config(self, name: str) -> Dict[str, Any]:
        return json.loads(self._file("configs", name, ".json").read_text())

    def traffic(self, name: str) -> Dict[str, Any]:
        return json.loads(self._file("traffic", name, ".json").read_text())

    def driver(self, name: str) -> ModuleType:
        return load_module(self._file("drivers", name, ".py"), f"_bench_driver_{name}")

    def metric_reader(self, name: str) -> ModuleType:
        return load_module(self._file("metrics", name, ".py"),
                           "_bench_metric_" + name.replace(".", "_").replace("-", "_"))


def load_module(path: Path, module_name: str) -> ModuleType:
    """The module in `path`, loaded under `module_name` (a metric's file name
    holds dots, so it is loaded by path and not imported by name)."""
    spec = importlib.util.spec_from_file_location(module_name, str(path))
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
