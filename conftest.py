"""Builds the JAX package's native region reader once, before any test
worker starts.

`demovlp_tpu/data/native.py::build_library` compiles
`native/libregionreader.so` in place on first use. Under pytest-xdist every
worker collects every file, and `tests/test_native_adversarial.py` asks for
the reader while collecting, so several workers could compile over one
file at once; a worker that loads a half-written library caches the
failure and skips its native tests. Here the controller (the only process
without `workerinput`) compiles it once with the same g++ command, into a
temporary file that is renamed into place, so the library is newer than its
source and `build_library` serves it to every worker without a rebuild.
Where g++ fails nothing changes. This file imports neither JAX nor the
package: tests/conftest.py sets JAX's platform first.
"""
from __future__ import annotations

import os
import subprocess
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "native" / "npz_region_reader.cc"
_LIB = _SRC.parent / "libregionreader.so"


def _build_native_reader() -> None:
    if not _SRC.exists() or (_LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime):
        return
    tmp = _LIB.with_name(f".{_LIB.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           str(_SRC), "-o", str(tmp), "-lz", "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, _LIB)
    except (OSError, subprocess.SubprocessError):
        pass
    finally:
        tmp.unlink(missing_ok=True)


def pytest_configure(config):
    if not hasattr(config, "workerinput"):
        _build_native_reader()
