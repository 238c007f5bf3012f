"""Nothing the harness runs loads JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference imports nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from benchmark.harness.outcome import FORBIDDEN, forbidden_modules
from benchmark.tests.tiny import BENCH, REPO

PROGRAM = "demovlp_tpu_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_whole_name_comparison(monkeypatch):
    monkeypatch.setitem(sys.modules, PROGRAM + "_probe_module", sys)
    assert forbidden_modules() == [] or set(forbidden_modules()) <= set(FORBIDDEN)
    assert "demovlp_tpu" in FORBIDDEN and PROGRAM not in FORBIDDEN
    monkeypatch.setitem(sys.modules, "demovlp_tpu.probe", sys)
    assert "demovlp_tpu" in forbidden_modules()


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".", 1)[0] not in FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".", 1)[0] != PROGRAM, (path, name)
            assert not name.startswith("benchmark.") or name.startswith("benchmark.reference"), (
                path, name)


def test_chip_path_loads_no_jax():
    """Import everything a run imports, program modules included, in a
    fresh interpreter, and list the forbidden top-level names loaded."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.run, benchmark.control\n"
        "from benchmark.harness.spec import Spec\n"
        "spec = Spec(benchmark.run.ROOT)\n"
        "for c in spec.cells.values():\n"
        "    spec.driver(spec.traffic(c.traffic)['driver'])\n"
        "    [spec.metric_reader(m.name) for m in spec.per_layer_of(c.name)]\n"
        "import demovlp_tpu_torch.cli.common, demovlp_tpu_torch.train.retrieval\n"
        "import demovlp_tpu_torch.serve, demovlp_tpu_torch.data.loader\n"
        "from benchmark.harness.outcome import forbidden_modules\n"
        "print(forbidden_modules())\n" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_loads_without_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.checks, benchmark.reference.precision\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == %r))\n"
            % (str(REPO), PROGRAM))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
