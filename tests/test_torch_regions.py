"""The port's frame sampling and npz region pipeline
(demovlp_tpu_torch.data.{sampling,regions}) against the JAX package's
(demovlp_tpu.data.{sampling,regions}): equal frame lists under the same
seeded generator, and bit-identical region arrays (np.array_equal, dtypes
equal) on frames written from a numpy seed: fewer, as many and more
regions than K, tied confidences, float64 features, class-deduped top-k and
an unreadable frame."""
from __future__ import annotations

import numpy as np
import pytest

from demovlp_tpu.data import regions as jregions
from demovlp_tpu.data import sampling as jsampling
from demovlp_tpu_torch.data import regions, sampling

K = 5


def write_frame(path, n, seed, ties=False, feat_dtype=np.float32, compressed=False):
    """One frame npz in the bottom-up-attention layout."""
    rng = np.random.RandomState(seed)
    w, h = 640, 480
    x1 = rng.uniform(0, w / 2, n)
    y1 = rng.uniform(0, h / 2, n)
    bbox = np.stack([x1, y1, x1 + rng.uniform(1, w / 2, n), y1 + rng.uniform(1, h / 2, n)],
                    axis=1).astype(np.float32)
    conf = rng.rand(n).astype(np.float32)
    if ties:
        conf = (rng.randint(0, 3, n) / 4).astype(np.float32)
    info = {"objects_conf": conf, "objects_id": rng.randint(0, 6, n), "image_w": w,
            "image_h": h}
    save = np.savez_compressed if compressed else np.savez
    save(str(path), x=rng.randn(n, regions.FEAT_DIM).astype(feat_dtype), bbox=bbox, info=info)


FRAMES = {"n<k": dict(n=3), "n=k": dict(n=K), "n>k": dict(n=12),
          "ties": dict(n=9, ties=True), "f8": dict(n=7, feat_dtype=np.float64)}


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            _assert_same(a[key], b[key])
    elif isinstance(a, (tuple, list)) and not isinstance(a, np.ndarray):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


@pytest.fixture()
def video(tmp_path):
    """Frames 0..4 of one kind each, in one directory."""
    for i, kw in enumerate(FRAMES.values()):
        write_frame(tmp_path / f"{i}.npz", seed=i, **kw)
    return tmp_path


@pytest.mark.parametrize("mode,fix_start", [("rand", None), ("uniform", None),
                                            ("uniform", 2)], ids=["rand", "uniform", "fix"])
def test_sample_frame_indices(mode, fix_start):
    for segments in (1, 3, 4, 8):
        for vlen in (1, 2, 3, 5, 8, 9, 13, 40):
            for seed in range(3):
                got = sampling.sample_frame_indices(segments, vlen, mode,
                                                    np.random.default_rng(seed), fix_start)
                want = jsampling.sample_frame_indices(segments, vlen, mode,
                                                      np.random.default_rng(seed), fix_start)
                assert got == want, (segments, vlen, seed)
                assert all(type(i) is int for i in got)


def test_sample_frame_indices_rejects_unknown_mode():
    with pytest.raises(NotImplementedError):
        sampling.sample_frame_indices(4, 8, "middle")


@pytest.mark.parametrize("kind", list(FRAMES))
def test_load_frame_regions(video, kind):
    path = video / f"{list(FRAMES).index(kind)}.npz"
    _assert_same(regions.load_frame_regions(str(path)), jregions.load_frame_regions(str(path)))


@pytest.mark.parametrize("kind", list(FRAMES))
def test_select_regions(video, kind):
    fr = jregions.load_frame_regions(str(video / f"{list(FRAMES).index(kind)}.npz"))
    for k in (1, K, 30):
        _assert_same(regions.select_regions([fr, fr], k), jregions.select_regions([fr, fr], k))


@pytest.mark.parametrize("idxs", [[0, 1, 2, 3, 4], [4, 4, 2], [1]], ids=["all", "repeat", "one"])
def test_read_video_regions(video, idxs):
    got = regions.read_video_regions(str(video), idxs, K)
    _assert_same(got, jregions.read_video_regions(str(video), idxs, K))
    assert got[0].shape == (len(idxs), K, regions.REGION_DIM)
    assert got[2] == [min(FRAMES[list(FRAMES)[i]]["n"], K) for i in idxs]


@pytest.mark.parametrize("kind", ["n<k", "n>k"])
def test_read_image_regions(video, kind):
    path = str(video / f"{list(FRAMES).index(kind)}.npz")
    _assert_same(regions.read_image_regions(path, K), jregions.read_image_regions(path, K))


@pytest.mark.parametrize("unique", [False, True], ids=["all", "unique-classes"])
def test_read_object_topk(video, unique):
    idxs = [0, 2, 7, 3]  # 7.npz does not exist: an all-ones block
    for top_k in (4, 10):
        got = regions.read_object_topk(str(video), idxs, top_k, unique)
        _assert_same(got, jregions.read_object_topk(str(video), idxs, top_k, unique))
        assert np.all(got[2] == 1.0)
