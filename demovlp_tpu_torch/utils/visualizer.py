"""HTML retrieval-ranking gallery (counterpart of
demovlp_tpu/utils/visualizer.py, the reference's utils/visualizer.py and
utils/html.py without the dominate package): `index.html` under the web
dir with the top-5 retrieved videos of sampled queries, each linking into
a `videos/` symlink to the source video dir. The page is byte for byte
the JAX package's.
"""
from __future__ import annotations

import html as _html
import os
from pathlib import Path
from typing import Dict, List

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
body {{ font-family: sans-serif; }}
table {{ border-collapse: collapse; margin-bottom: 24px; }}
td {{ border: 1px solid #ccc; padding: 6px; vertical-align: top; width: 220px; }}
video, img {{ width: 200px; }}
.h {{ font-size: 18px; margin: 8px 0; }}
</style></head><body>
{body}
</body></html>
"""


class RetrievalVis:
    """Saves an HTML page of retrieval rankings each `vis_vid_freq` epochs."""

    def __init__(
        self,
        exp_name: str,
        web_dir: str,
        src_video_dir: str = "",
        vis_vid_freq: int = 1,
        num_samples: int = 50,
        data_type: str = "videos",
    ):
        self.name = exp_name
        self.web_dir = Path(web_dir)
        self.vis_vid_freq = vis_vid_freq
        self.num_samples = num_samples
        self.data_type = data_type
        self.web_dir.mkdir(parents=True, exist_ok=True)

        if src_video_dir:
            src = Path(os.path.expandvars(src_video_dir)).absolute()
            sym = (self.web_dir / "videos").absolute()
            if sym.is_symlink():
                sym.unlink()
            if src.exists() and not sym.exists():
                sym.symlink_to(src)

    def visualize_ranking(self, sims, epoch: int, meta: Dict, nested_metrics: Dict):
        if not (self.vis_vid_freq and epoch % self.vis_vid_freq == 0):
            return
        sims = np.asarray(sims)
        dists = -sims
        rng = np.random.RandomState(0)
        sorted_ranks = np.argsort(dists, axis=1)
        gt_dists = np.diag(dists)
        top_k = 5
        n = min(self.num_samples, dists.shape[0])
        sample = rng.choice(np.arange(dists.shape[0]), size=n, replace=False)

        rankings = []
        for ii in sample:
            ranked_idx = sorted_ranks[ii][:top_k]
            rankings.append(
                {
                    "gt-sim": -gt_dists[ii],
                    "gt-captions": meta["raw_captions"][ii],
                    "gt-rank": int(np.where(sorted_ranks[ii] == ii)[0][0]),
                    "gt-path": meta["paths"][ii],
                    "top-k-sims": -dists[ii][ranked_idx],
                    "top-k-paths": [meta["paths"][j] for j in ranked_idx],
                }
            )
        metrics = nested_metrics.get("t2v_metrics", {})
        self._write_page(rankings, epoch, metrics)

    def _media_cell(self, rel_path: str, caption_html: str) -> str:
        src = f"videos/{rel_path}"
        if self.data_type == "videos":
            media = f'<video controls src="{_html.escape(src)}"></video>'
        else:
            media = f'<img src="{_html.escape(src)}">'
        return f"<td>{media}<br>{caption_html}</td>"

    def _write_page(self, rankings: List[Dict], epoch: int, metrics: Dict) -> None:
        parts = [f'<div class="h">epoch [{epoch}] — {_html.escape(self.name)}</div>']
        if metrics:
            parts.append(
                '<div class="h">'
                f"R1: {metrics.get('R1', 0):.1f}, R5: {metrics.get('R5', 0):.1f}, "
                f"R10: {metrics.get('R10', 0):.1f}, MedR: {metrics.get('MedR', 0)}"
                "</div>"
            )
        for r in rankings:
            cells = [
                self._media_cell(
                    str(r["gt-path"]),
                    f"{_html.escape(str(r['gt-captions']))}<br>"
                    f"<b>GT — Rank: {r['gt-rank']}, Sim: {r['gt-sim']:.3f}</b>",
                )
            ]
            for idx, (p, s) in enumerate(zip(r["top-k-paths"], r["top-k-sims"])):
                cells.append(
                    self._media_cell(str(p), f"<b>Rank: {idx}, Sim: {s:.3f}</b>")
                )
            parts.append("<table><tr>" + "".join(cells) + "</tr></table>")
        page = _PAGE.format(title=_html.escape(self.name), body="\n".join(parts))
        (self.web_dir / "index.html").write_text(page)
