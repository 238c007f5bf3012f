"""The configs chip_smoke.py drives at full width on the card
(configs/bench/{ft,qa,mc}_synthetic_f8.json) keep the shape of the
fine-tune configs they name: frames, regions, batch, loss, optimizer rate,
arch and precision of configs/ft/msrvtt_{o2t,qa,mc}-select.json, with the
synthetic dataset in place of the real one. Checked without building the
full-width models (their loaders only)."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from demovlp_tpu_torch.cli import common

ROOT = Path(__file__).resolve().parents[1]
CASES = {
    "ft_synthetic_f8": ("msrvtt_o2t-select", "retrieval", 512),
    "qa_synthetic_f8": ("msrvtt_qa-select", "qa", 1024),
    "mc_synthetic_f8": ("msrvtt_mc-select", "mc", 256),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_bench_config_keeps_the_source_shape(name):
    source, task, samples = CASES[name]
    cfg = json.loads((ROOT / "configs" / "bench" / f"{name}.json").read_text())
    ref = json.loads((ROOT / "configs" / "ft" / f"{source}.json").read_text())
    assert source in cfg["name"]
    for key in ("arch", "loss", "optimizer", "precision", "metrics"):
        want, got = ref[key], cfg[key]
        if key == "arch":  # the text model is the repo's own, not a pretrained path
            want = json.loads(json.dumps(want))
            got = json.loads(json.dumps(got))
            for tree in (want, got):
                tree["args"]["text_params"].pop("model")
                tree["args"]["text_params"].pop("pretrained")
        assert got == want, key
    args, ref_args = cfg["data_loader"]["args"], ref["data_loader"]["args"]
    assert args["batch_size"] == ref_args["batch_size"]
    obj_p = args["object_params"]
    assert (obj_p["num_frames"], obj_p["object_num"]) == (8, 30)
    assert (obj_p["task"], obj_p["num_samples"]) == (task, samples)
    train, val = common.init_dataloaders(cfg, val_split="test" if task != "retrieval" else "val")
    ds = val[0].dataset
    assert (ds.segments, ds.object_num, len(ds)) == (8, 30, samples)
    if task == "qa":
        assert ds.num_label == ref["arch"]["args"]["object_params"]["num_label"] == 1500
    if task == "mc":
        assert ds.num_options == 5 and cfg["trainer"]["mc_eval_batch"] == 8
    if task != "mc":
        assert len(train[0]) == 16  # 16 train steps
