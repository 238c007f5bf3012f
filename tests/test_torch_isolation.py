"""The port stands alone: no module of demovlp_tpu_torch (nor chip_smoke.py)
imports JAX, flax, optax, orbax or the JAX package, every port module
imports with those blocked, and entry points refuse to run without a card
unless the CPU is asked for."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "demovlp_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "demovlp_tpu"}


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_top_levels(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _modules():
    return [
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in sorted(PKG.rglob("*.py"))
    ]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = set(_imported_top_levels(path)) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_top_level_match_is_exact():
    """`demovlp_tpu_torch` must not count as `demovlp_tpu`."""
    assert "demovlp_tpu_torch" not in FORBIDDEN
    assert set(_imported_top_levels(PKG / "serve.py")) & FORBIDDEN == set()
    assert "demovlp_tpu_torch" in set(_imported_top_levels(PKG / "serve.py"))


def test_modules_import_with_jax_blocked():
    code = (
        "import sys\n"
        f"for name in {sorted(FORBIDDEN)!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for mod in {_modules()!r}:\n"
        "    importlib.import_module(mod)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_cli_raises_without_a_card(monkeypatch, tmp_path):
    from demovlp_tpu_torch.cli.extract_embeddings import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(["-c", str(ROOT / "configs/smoke/synthetic_retrieval.json"),
             "--output", str(tmp_path / "e.npz")])
    assert not (tmp_path / "e.npz").exists()
