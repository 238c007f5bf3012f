"""Without a card a run fails and prints no result; outside a checkout
(only BENCHMARK.json and the benchmark's files) it fails too."""
from __future__ import annotations

import shutil
import subprocess
import sys

import pytest

from benchmark.tests.tiny import BENCH, REPO


def _run(cwd, *extra):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "pt_cc_f1",
                           "--seed", "2147483659", "--seconds", "1", "--trace", "0", *extra],
                          capture_output=True, text=True, timeout=300, cwd=str(cwd))


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible here")
    out = _run(REPO)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_bare_directory_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path)
    assert out.returncode != 0
    assert not out.stdout.strip().startswith("{")
