"""ctypes binding of the port's native npz region decoder
(demovlp_tpu_torch/native/npz_region_reader.cc), built at first use.

`get_native_reader()` compiles the source with g++ into
`build/native/libregionreader-<source digest>.so` at the repo root (listed
in .gitignore): through a temporary file and `os.replace`, so processes
that build at once each load a whole library, and an edited source gets a
new file name. A failed build or load raises with the compiler's output;
the numpy reader (data/regions.py) is used only where the caller asks for
it: `DEMOVLP_NATIVE=0` in the environment (`native_enabled()`).

`reader.read_paths_into(paths, k, feat, mask, lens)` decodes frame files
into caller-owned buffers and returns a status a file (0 = decoded);
`reader.read_paths(paths, k)` returns (feat, mask, lens) as
`regions.select_regions` does and raises on a file it cannot decode.
`STATS` counts the frames decoded natively and the batch rows the loader
redid on the per-sample path (`reset_stats()` sets both to 0).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from demovlp_tpu_torch.data.regions import REGION_DIM

SRC = Path(__file__).resolve().parents[1] / "native" / "npz_region_reader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lz", "-lpthread")

#: frames decoded by the native reader, and batch rows whose files it could
#: not decode, redone per sample (data/loader.py); since the last reset
STATS = {"frames_native": 0, "rows_redone": 0}
_STATS_LOCK = threading.Lock()
_READER_LOCK = threading.Lock()
_reader: Optional["NativeRegionReader"] = None


def reset_stats() -> None:
    with _STATS_LOCK:
        for k in STATS:
            STATS[k] = 0


def count(key: str, n: int) -> None:
    with _STATS_LOCK:
        STATS[key] += n


def native_enabled() -> bool:
    """False where the caller asked for the numpy reader (DEMOVLP_NATIVE=0)."""
    return os.environ.get("DEMOVLP_NATIVE", "1") != "0"


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libregionreader-{digest}.so"


def build_library() -> Path:
    """The library for the current source, compiled if it is not there yet.
    Raises RuntimeError with the compiler's output when g++ fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"native reader build failed: {' '.join(cmd)}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native reader build failed (g++ exited {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path


class NativeRegionReader:
    """The C API over ctypes."""

    def __init__(self, lib_path: Path, n_threads: Optional[int] = None):
        self.path = Path(lib_path)
        self.lib = ctypes.CDLL(str(lib_path))
        self.lib.demovlp_read_frames.restype = ctypes.c_int
        self.lib.demovlp_read_frames.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        self.lib.demovlp_region_dim.restype = ctypes.c_int
        self.lib.demovlp_region_dim.argtypes = []
        if self.lib.demovlp_region_dim() != REGION_DIM:
            raise RuntimeError(f"{lib_path}: region dim {self.lib.demovlp_region_dim()}, "
                               f"expected {REGION_DIM}")
        self.n_threads = n_threads or min(8, os.cpu_count() or 1)

    def read_paths_into(self, paths: Sequence[str], object_num: int, feat: np.ndarray,
                        mask: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """Decode npz files into contiguous buffers (feat (N,K,2054) f32,
        mask (N,K) f32, lens (N,) i32). Returns the status a file (0 = ok)
        without raising on a file it cannot decode."""
        f = len(paths)
        if f == 0 or object_num <= 0:
            raise ValueError(f"read_paths_into: {f} paths, K={object_num}")
        for name, arr, dtype, shape in (("feat", feat, np.float32, (f, object_num, REGION_DIM)),
                                        ("mask", mask, np.float32, (f, object_num)),
                                        ("lens", lens, np.int32, (f,))):
            if arr.dtype != dtype or arr.shape != shape or not arr.flags.c_contiguous:
                raise ValueError(f"{name}: expected a C-contiguous {np.dtype(dtype)} array "
                                 f"of shape {shape}, got {arr.dtype} {arr.shape}")
        status = np.zeros(f, dtype=np.int32)
        arr = (ctypes.c_char_p * f)(*[os.fsencode(p) for p in paths])
        rc = self.lib.demovlp_read_frames(
            arr, f, object_num, self.n_threads,
            feat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if rc != 0 and not status.any():
            raise ValueError(f"native decode argument failure rc={rc}")
        count("frames_native", int(np.count_nonzero(status == 0)))
        return status

    def read_paths(self, paths: Sequence[str], object_num: int):
        """(feat (F,K,2054), mask (F,K), lens list); raises IOError when a
        file cannot be decoded."""
        f = len(paths)
        feat = np.zeros((f, object_num, REGION_DIM), dtype=np.float32)
        mask = np.zeros((f, object_num), dtype=np.float32)
        lens = np.zeros(f, dtype=np.int32)
        status = self.read_paths_into(paths, object_num, feat, mask, lens)
        if status.any():
            raise IOError(f"native decode failed, status {status.tolist()}")
        return feat, mask, lens.tolist()


def get_native_reader() -> NativeRegionReader:
    """The process's reader, built and loaded at the first call; raises
    when it cannot be built or loaded."""
    global _reader
    with _READER_LOCK:
        if _reader is None:
            _reader = NativeRegionReader(build_library())
        return _reader
