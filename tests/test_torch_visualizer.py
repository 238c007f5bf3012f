"""The retrieval-ranking gallery: the port's RetrievalVis against the JAX
package's on the same seeded sims, metadata and metrics writes the same
index.html, byte for byte (captions with HTML metacharacters included),
links the same `videos/` directory and skips the same epochs."""
from __future__ import annotations

import numpy as np
import pytest

from demovlp_tpu.utils.visualizer import RetrievalVis as JaxVis
from demovlp_tpu_torch.utils.visualizer import RetrievalVis

METRICS = {"t2v_metrics": {"R1": 12.5, "R5": 37.5, "R10": 62.5, "MedR": 7.0},
           "v2t_metrics": {"R1": 0.0}}


def _inputs(n, seed=0):
    rng = np.random.RandomState(seed)
    sims = (rng.randn(n, n) + 2.0 * np.eye(n)).astype(np.float32)
    meta = {"paths": [f"clip_{i:03d}.mp4" for i in range(n)],
            "raw_captions": [f"a <b>dog</b> & cat #{i}" for i in range(n)]}
    return sims, meta


@pytest.mark.parametrize("n,num_samples,data_type,metrics", [
    (12, 5, "videos", METRICS),
    (7, 50, "images", METRICS),
    (9, 9, "videos", {}),
])
def test_index_html_matches_jax(tmp_path, n, num_samples, data_type, metrics):
    sims, meta = _inputs(n, seed=n)
    pages = []
    for cls, sub in ((JaxVis, "jax"), (RetrievalVis, "port")):
        vis = cls("SyntheticSmoke", str(tmp_path / sub), num_samples=num_samples,
                  data_type=data_type)
        vis.visualize_ranking(sims, epoch=3, meta=meta, nested_metrics=metrics)
        pages.append((tmp_path / sub / "index.html").read_bytes())
    assert pages[0] == pages[1]
    assert b"&lt;b&gt;dog&lt;/b&gt; &amp; cat" in pages[1]


def test_video_dir_link_and_epoch_frequency_match_jax(tmp_path):
    src = tmp_path / "videos_src"
    src.mkdir()
    sims, meta = _inputs(6)
    for cls, sub in ((JaxVis, "jax"), (RetrievalVis, "port")):
        vis = cls("exp", str(tmp_path / sub), src_video_dir=str(src), vis_vid_freq=2)
        assert (tmp_path / sub / "videos").resolve() == src.resolve()
        vis.visualize_ranking(sims, epoch=1, meta=meta, nested_metrics=METRICS)
        assert not (tmp_path / sub / "index.html").exists()
        vis.visualize_ranking(sims, epoch=2, meta=meta, nested_metrics=METRICS)
    assert (tmp_path / "jax" / "index.html").read_bytes() == \
        (tmp_path / "port" / "index.html").read_bytes()
