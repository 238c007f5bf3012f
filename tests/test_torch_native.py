"""The port's native npz reader (demovlp_tpu_torch/native/npz_region_reader.cc
through demovlp_tpu_torch.data.native) against the JAX package's numpy
reader, demovlp_tpu.data.regions.read_video_regions: bit-identical
features, masks and lens on np.savez and np.savez_compressed frames (the
frames have distinct confidences: on ties the native reader keeps file
order, numpy's argsort its sort's order), a nonzero status on a truncated
or missing file for that row only, the build under build/native/ (never
beside the source or over the JAX package's native/libregionreader.so),
four processes building into one empty directory at once, and a failed
build that raises with the compiler's output.

The reader is built in a fixture. Where g++ or zlib's headers are missing
the fixture skips with that reason; where they are present a build
failure fails the tests.
"""
from __future__ import annotations

import multiprocessing
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from demovlp_tpu.data.regions import read_video_regions as jax_read_video_regions
from demovlp_tpu_torch.data import native
from demovlp_tpu_torch.data.datasets.base import RegionDataset
from demovlp_tpu_torch.data.loader import RegionDataLoader
from demovlp_tpu_torch.data.regions import REGION_DIM

from .test_torch_regions import write_frame

ROOT = Path(__file__).resolve().parents[1]
K = 30


def _toolchain_reason():
    if shutil.which("g++") is None:
        return "no g++"
    probe = subprocess.run(["g++", "-E", "-x", "c++", "-"], input="#include <zlib.h>\n",
                           capture_output=True, text=True, timeout=60)
    return None if probe.returncode == 0 else "no zlib.h"


@pytest.fixture(scope="module")
def reader():
    reason = _toolchain_reason()
    if reason:
        pytest.skip(f"the native reader cannot be built here: {reason}")
    return native.get_native_reader()


def _video(root, n_frames, seed, compressed=False):
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n_frames):
        write_frame(root / f"{i}.npz", n=int(rng.randint(1, 40)), seed=seed * 100 + i,
                    compressed=compressed)
    return root


def _assert_same(got, want):
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    assert list(got[2]) == list(want[2])


@pytest.mark.parametrize("compressed", [False, True], ids=["savez", "savez_compressed"])
def test_read_video_matches_numpy(reader, tmp_path, compressed):
    vdir = _video(tmp_path / "v", 6, seed=1, compressed=compressed)
    idxs = [0, 2, 3, 5, 5]
    _assert_same(reader.read_paths([str(vdir / f"{i}.npz") for i in idxs], K),
                 jax_read_video_regions(str(vdir), idxs, K))


def test_batch_of_64_paths_matches_numpy(reader, tmp_path):
    paths = []
    for v in range(8):
        vdir = _video(tmp_path / f"v{v}", 8, seed=10 + v, compressed=v % 4 == 0)
        paths += [str(vdir / f"{i}.npz") for i in range(8)]
    assert len(paths) == 64
    feat = np.zeros((64, K, REGION_DIM), np.float32)
    mask = np.zeros((64, K), np.float32)
    lens = np.zeros(64, np.int32)
    before = native.STATS["frames_native"]
    status = reader.read_paths_into(paths, K, feat, mask, lens)
    assert not status.any()
    assert native.STATS["frames_native"] - before == 64
    for v in range(8):
        rows = slice(8 * v, 8 * v + 8)
        _assert_same((feat[rows], mask[rows], lens[rows]),
                     jax_read_video_regions(str(tmp_path / f"v{v}"), range(8), K))


@pytest.mark.parametrize("damage", ["truncated", "missing"])
def test_bad_file_fails_its_row_only(reader, tmp_path, damage):
    vdir = _video(tmp_path / "v", 4, seed=3)
    bad = vdir / "2.npz"
    if damage == "truncated":
        bad.write_bytes(bad.read_bytes()[:1000])
    else:
        bad.unlink()
    paths = [str(vdir / f"{i}.npz") for i in range(4)]
    feat = np.zeros((4, K, REGION_DIM), np.float32)
    mask = np.zeros((4, K), np.float32)
    lens = np.zeros(4, np.int32)
    status = reader.read_paths_into(paths, K, feat, mask, lens)
    assert status[2] != 0 and not status[[0, 1, 3]].any()
    _assert_same((feat[[0, 1, 3]], mask[[0, 1, 3]], lens[[0, 1, 3]]),
                 jax_read_video_regions(str(vdir), [0, 1, 3], K))
    with pytest.raises(OSError):
        reader.read_paths(paths[1:3], K)


def test_buffers_are_checked(reader, tmp_path):
    vdir = _video(tmp_path / "v", 2, seed=4)
    paths = [str(vdir / "0.npz"), str(vdir / "1.npz")]
    with pytest.raises(ValueError):
        reader.read_paths_into(paths, K, np.zeros((2, K, REGION_DIM), np.float64),
                               np.zeros((2, K), np.float32), np.zeros(2, np.int32))
    with pytest.raises(ValueError):
        reader.read_paths_into(paths, K, np.zeros((1, K, REGION_DIM), np.float32),
                               np.zeros((2, K), np.float32), np.zeros(2, np.int32))


def test_library_is_built_under_build_native(reader):
    jax_lib = ROOT / "native" / "libregionreader.so"
    before = jax_lib.stat().st_mtime_ns if jax_lib.exists() else None
    path = native.build_library()
    assert path == reader.path
    assert path.parent == ROOT / "build" / "native"
    assert path.name.startswith("libregionreader-") and path != jax_lib
    assert not list(native.SRC.parent.glob("*.so"))
    assert (jax_lib.stat().st_mtime_ns if jax_lib.exists() else None) == before
    assert not list(path.parent.glob(f"*.{os.getpid()}.*.tmp"))  # this process left none


def _build_in(build_dir: str):
    native.BUILD_DIR = Path(build_dir)
    path = native.build_library()
    reader = native.NativeRegionReader(path)
    return str(path), reader.lib.demovlp_region_dim()


def test_concurrent_builds_each_load_a_library(reader, tmp_path):
    build_dir = tmp_path / "build"
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(4) as pool:
        results = pool.map(_build_in, [str(build_dir)] * 4, chunksize=1)
    assert {r[1] for r in results} == {REGION_DIM}
    assert len({r[0] for r in results}) == 1
    assert [p.name for p in build_dir.iterdir()] == [Path(results[0][0]).name]


def test_failed_build_raises_with_compiler_output(reader, tmp_path, monkeypatch):
    bad = tmp_path / "bad.cc"
    bad.write_text("int f( { return 0; }\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ exited") as exc:
        native.build_library()
    assert "bad.cc" in str(exc.value)
    assert not list((tmp_path / "build").glob("*"))


class _Tree(RegionDataset):
    """Every subdirectory of data_dir is a video."""

    def _load_metadata(self):
        self.metadata = sorted(p.name for p in Path(self.data_dir).iterdir())

    def _object_path(self, index):
        return str(Path(self.data_dir) / self.metadata[index])

    def _text(self, index, rng):
        return self.metadata[index]


def test_unbuildable_reader_raises_and_numpy_is_asked_for(reader, tmp_path, monkeypatch):
    """No silent fallback: where the reader cannot be built, a dataset item
    and a loader batch raise; DEMOVLP_NATIVE=0 reads with numpy."""
    for v in range(3):
        _video(tmp_path / "videos" / f"v{v}", 3, seed=20 + v)
    ds = _Tree("tree", object_params={"num_frames": 2, "object_num": 5},
               data_dir=str(tmp_path / "videos"))
    bad = tmp_path / "bad.cc"
    bad.write_text("not c++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_reader", None)
    with pytest.raises(RuntimeError, match="native reader build failed"):
        ds.get_item(0, np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="native reader build failed"):
        next(iter(RegionDataLoader(ds, batch_size=2)))
    monkeypatch.setenv("DEMOVLP_NATIVE", "0")
    item = ds.get_item(0, np.random.default_rng(0))
    assert item["object"].shape == (2, 5, REGION_DIM) and ds.resample_count == 0
    assert next(iter(RegionDataLoader(ds, batch_size=2)))["object"].shape == (2, 2, 5, REGION_DIM)


def test_native_switch(monkeypatch):
    monkeypatch.delenv("DEMOVLP_NATIVE", raising=False)
    assert native.native_enabled()
    monkeypatch.setenv("DEMOVLP_NATIVE", "0")
    assert not native.native_enabled()
    native.reset_stats()
    assert native.STATS == {"frames_native": 0, "rows_redone": 0}
