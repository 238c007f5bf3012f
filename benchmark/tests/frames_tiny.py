"""A scratch checkout for the CPU tests of the pixel cell and the
four-rank cell, as tiny.py makes one for the first cells: the benchmark's
folder beside a BENCHMARK.json whose cells run the committed
configurations narrowed to a size the CPU runs in seconds. The metric
lists keep only the cells of this checkout."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from benchmark.tests.tiny import BENCH, REPO, TEXT


def narrow_frozen(config: dict, batch: int = 4) -> dict:
    c = copy.deepcopy(config)
    p = c["program"]
    p["precision"]["compute"] = "float32"
    a = p["arch"]["args"]
    a["text_params"]["config"] = dict(TEXT)
    a["video_params"].update(resolution=48, embed_dim=32, depth=2, heads=2, num_frames=3)
    a["projection_dim"] = 16
    p["data_loader"]["args"]["batch_size"] = batch
    return c


def make_root(tmp: Path) -> Path:
    """A checkout root under `tmp` with the tiny cells `frozen` (pixels,
    float32) and `dp` (the four-rank driver's cell at two ranks over gloo,
    float32)."""
    root = Path(tmp) / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfgs, traffic = root / "benchmark" / "configs", root / "benchmark" / "traffic"
    c = json.loads((cfgs / "frozen_in_time_4f.json").read_text())
    (cfgs / "tiny_frozen.json").write_text(json.dumps(narrow_frozen(c)))
    t = json.loads((traffic / "ft_msrvtt_frozen4f.json").read_text())
    t.update(samples_per_epoch=512, pool=6, trace_seconds=1, reference_chunk=2)
    (traffic / "tiny_frozen.json").write_text(json.dumps(t))
    cells = [{"name": "frozen", "config": "tiny_frozen", "traffic": "tiny_frozen", "chips": 1,
              "why": "tiny pixel fine-tuning"}]
    dp_traffic = traffic / "pt_cc_f1_dp4.json"
    if dp_traffic.exists():
        c = json.loads((cfgs / "demovlp_pt_f1.json").read_text())
        p = c["program"]
        p["precision"]["compute"] = "float32"
        p["loss"]["args"]["local_dtype"] = "float32"
        a = p["arch"]["args"]
        a["text_params"]["config"] = dict(TEXT)
        a["object_params"].update(embed_dim=32, depth=2, heads=2)
        a["projection_dim"] = 16
        p["data_loader"]["args"]["batch_size"] = 4
        (cfgs / "tiny_dp.json").write_text(json.dumps(c))
        t = json.loads(dp_traffic.read_text())
        t.update(samples_per_epoch=4096, trace_seconds=1, ranks=2, backend="gloo",
                 deadline_s=240)
        (traffic / "tiny_dp.json").write_text(json.dumps(t))
        cells.append({"name": "dp", "config": "tiny_dp", "traffic": "tiny_dp", "chips": 1,
                      "why": "tiny data-parallel pre-training"})
    bench["workloads"] = cells
    names = {cell["name"] for cell in cells}
    rename = {"ft_msrvtt_frozen4f": "frozen", "pt_cc_f1_dp4": "dp"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"] if rename.get(w) in names]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
