"""Length-grouped batching (`data_loader.args.length_grouped`) and the
caption-length proxy, on the CPU, against the JAX package.

* Batches: the port's train loader over a long-tail synthetic dataset
  gives the JAX `RegionDataLoader`'s batches index for index (process 0 of
  1, the same seed), for two epochs, with the default (32, 48, 64) edges
  and with narrower ones passed as the trainer's `text_buckets`, so several
  classes meet; and in "sort" mode (the exact-length stable sort) for one
  process and for each of two simulated processes. A mode that is neither a
  bool nor "sort" raises.
* Coverage: grouping reorders an epoch and drops nothing that ungrouped
  batching keeps: the same batch count and sizes, and every sample once
  where the batch size divides the dataset.
* Inert on eval loaders: a val loader (no shuffle, the partial batch kept)
  asked to group batches in dataset order.
* The train CLI's loaders group by the trainer's `text_buckets`, else by
  the default edges.
* text_lengths equals the JAX package's counts on the committed MSVD,
  WebVid, DiDeMo and CC3M split files and on a table with a missing
  caption.
* The bench config configs/bench/ab_local_bf16_fast.json keeps the shape of
  configs/pt/o2t-cl-local-select-loss-cc-fast.json, and its first epoch
  runs at least two bucket lengths.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from demovlp_tpu.data.datasets import dataset_object_loader as jax_dataset
from demovlp_tpu.data.loader import RegionDataLoader as JaxLoader
from demovlp_tpu_torch.cli import common
from demovlp_tpu_torch.data.datasets import dataset_object_loader
from demovlp_tpu_torch.data.loader import MultiDistTextObjectVideoDataLoader, RegionDataLoader
from demovlp_tpu_torch.data.tokenizer import SimpleTokenizer
from demovlp_tpu_torch.train.steps import parse_text_buckets, prepare_batch

ROOT = Path(__file__).resolve().parents[1]
META = ROOT / "meta_data"
OBJ_P = dict(num_frames=1, object_num=2, task="retrieval", caption_style="long_tail")


def _datasets(n: int):
    obj_p = dict(OBJ_P, num_samples=n)
    return (dataset_object_loader("SyntheticObjectSelect", text_params={}, object_params=obj_p,
                                  split="train"),
            jax_dataset("SyntheticObjectSelect", text_params={}, object_params=obj_p,
                        split="train"))


def _indices(batch):
    return [int(m["paths"].split("//")[1]) for m in batch["meta"]]


@pytest.mark.parametrize("buckets", [None, (8, 12, 16)], ids=["class-default", "class-narrow"])
def test_batches_match_jax_index_for_index(buckets):
    tds, jds = _datasets(200)
    kw = dict(batch_size=16, shuffle=True, drop_last=True, seed=3, num_workers=2,
              length_grouped=True)
    tdl = RegionDataLoader(tds, text_buckets=buckets, **kw)
    jdl = JaxLoader(jds, process_index=0, process_count=1,
                    length_buckets=buckets or (32, 48, 64), **kw)
    buckets = tdl.text_buckets
    assert tdl.length_grouped and jdl.length_grouped
    for epoch in (1, 2):
        tdl.set_epoch(epoch)
        jdl.set_epoch(epoch)
        got = [b.tolist() for b in tdl.batch_indices()]
        want = [_indices(b) for b in jdl]
        assert got == want
        assert got == [_indices(b) for b in tdl]
    lens = np.asarray(tds.text_lengths())
    classes = {int(np.searchsorted(buckets, lens[i] + 2)) for b in got for i in b}
    assert len(classes) > 1 or buckets == (32, 48, 64)  # the narrow edges meet several
    # all batches but those at a class boundary hold one class
    pure = sum(len({int(np.searchsorted(buckets, lens[i] + 2)) for i in b}) == 1 for b in got)
    assert pure >= len(got) - len(classes) + 1


def test_sort_mode_is_refused():
    """"sort" was refused before it was ported; its batches are now held to
    JAX's in test_sort_batches_match_jax. The name is kept for the refusal
    that stays: a mode that is neither a bool nor "sort" raises."""
    tds, _ = _datasets(32)
    with pytest.raises(NotImplementedError, match="bucket"):
        RegionDataLoader(tds, batch_size=16, shuffle=True, drop_last=True,
                         length_grouped="bucket")


@pytest.mark.parametrize("count", [1, 2], ids=["one-process", "two-processes"])
def test_sort_batches_match_jax(count):
    """length_grouped "sort": each process's batches equal the JAX
    loader's index for index, two epochs; within the global order before
    the batch shuffle the lengths never fall."""
    tds, jds = _datasets(200)
    kw = dict(batch_size=8, shuffle=True, drop_last=True, seed=5, num_workers=2,
              length_grouped="sort")
    lens = np.asarray(tds.text_lengths())
    for index in range(count):
        tdl = RegionDataLoader(tds, process_index=index, process_count=count, **kw)
        jdl = JaxLoader(jds, process_index=index, process_count=count, **kw)
        assert tdl.length_group_mode == jdl.length_group_mode == "sort"
        for epoch in (1, 2):
            tdl.set_epoch(epoch)
            jdl.set_epoch(epoch)
            got = [b.tolist() for b in tdl.batch_indices()]
            assert got == [_indices(b) for b in jdl]
            # batches are runs of the sorted order: a batch's lengths never fall
            assert all(np.all(np.diff(lens[b]) >= 0) for b in got)
        order, _ = tdl.host_indices()
        assert np.all(np.diff(lens[order]) >= 0) and len(order) == 200 // count


@pytest.mark.parametrize("n", [192, 200], ids=["divisible", "ragged"])
def test_grouping_keeps_coverage(n):
    tds, _ = _datasets(n)
    kw = dict(batch_size=16, shuffle=True, drop_last=True, seed=0)
    plain = RegionDataLoader(tds, **kw)
    grouped = RegionDataLoader(tds, length_grouped=True, **kw)
    plain.set_epoch(1)
    grouped.set_epoch(1)
    a, b = plain.batch_indices(), grouped.batch_indices()
    assert [len(x) for x in a] == [len(x) for x in b] and len(b) == n // 16
    flat = np.concatenate(b)
    assert len(set(flat.tolist())) == len(flat)
    if n % 16 == 0:
        assert sorted(flat.tolist()) == sorted(np.concatenate(a).tolist()) == list(range(n))
    assert [x.tolist() for x in a] != [x.tolist() for x in b]


def test_inert_on_eval_loaders():
    args = dict(dataset_name="SyntheticObjectSelect", text_params={},
                object_params=dict(OBJ_P, num_samples=50), batch_size=16, length_grouped=True)
    val = MultiDistTextObjectVideoDataLoader(split="test", **args)
    unshuffled = RegionDataLoader(val.dataset, batch_size=16, shuffle=False, drop_last=True,
                                  length_grouped=True)
    assert not val.length_grouped and not unshuffled.length_grouped
    want = np.arange(50)
    assert np.array_equal(np.concatenate(val.batch_indices()), want)
    assert np.array_equal(np.concatenate(unshuffled.batch_indices()), want[:48])
    train = MultiDistTextObjectVideoDataLoader(split="train", **args)
    assert train.length_grouped and train.text_buckets == (32, 48, 64)


@pytest.mark.parametrize("buckets,want", [
    ([64, 32, 48], (32, 48, 64)),
    ([8, 12, 16], (8, 12, 16)),
    (None, (32, 48, 64)),
], ids=["fast", "narrow", "unset"])
def test_cli_loaders_group_by_trainer_buckets(buckets, want):
    cfg = {"trainer": {"text_buckets": buckets},
           "data_loader": {"type": "MultiDistTextObjectVideoDataLoader", "args": dict(
               dataset_name="SyntheticObjectSelect", text_params={},
               object_params=dict(OBJ_P, num_samples=32), batch_size=16,
               length_grouped=True)}}
    train, val = common.init_dataloaders(cfg)
    assert train[0].length_grouped and train[0].text_buckets == want
    assert not val[0].length_grouped


@pytest.mark.parametrize("name,split", [
    ("MSVDObjectSelect", "test"),
    ("WebVidObjectSelect", "val"),
    ("DiDeMoObjectSelect", "test"),
    ("ConceptualCaptions3MObjectSelect", "val"),
])
def test_text_lengths_match_jax(name, split, monkeypatch):
    monkeypatch.setenv("DEMOVLP_META_DIR", str(META))
    ds = dataset_object_loader(name, text_params={}, object_params={}, split=split)
    got = ds.text_lengths()
    assert got.dtype == np.int32 and len(got) == len(ds) > 0
    want = jax_dataset(name, text_params={}, object_params={}, split=split).text_lengths()
    np.testing.assert_array_equal(got, np.asarray(want))


def test_text_lengths_missing_caption(tmp_path, monkeypatch):
    rows = ["a dog runs in the park\tv0", "\tv1", "  two  spaces  \tv2", "1234\tv3"]
    (tmp_path / "webvid_validation_success_full.tsv").write_text("\n".join(rows) + "\n")
    monkeypatch.setenv("DEMOVLP_META_DIR", str(tmp_path))
    ds = dataset_object_loader("WebVidObjectSelect", text_params={}, object_params={},
                               split="val")
    want = jax_dataset("WebVidObjectSelect", text_params={}, object_params={},
                       split="val").text_lengths()
    np.testing.assert_array_equal(ds.text_lengths(), np.asarray(want))
    np.testing.assert_array_equal(ds.text_lengths(), [6, 1, 2, 1])


def test_fast_bench_config_keeps_the_source_shape():
    cfg = json.loads((ROOT / "configs" / "bench" / "ab_local_bf16_fast.json").read_text())
    ref = json.loads((ROOT / "configs" / "pt" /
                      "o2t-cl-local-select-loss-cc-fast.json").read_text())
    assert cfg["trainer"]["text_buckets"] == ref["trainer"]["text_buckets"] == [32, 48, 64]
    for key in ("loss", "precision", "metrics"):
        assert cfg[key] == ref[key], key
    args = cfg["data_loader"]["args"]
    for ref_sec in ref["data_loader"]:
        ref_args = ref_sec["args"]
        assert args["length_grouped"] is ref_args["length_grouped"] is True
        assert args["batch_size"] == ref_args["batch_size"] == 128
        assert (args["object_params"]["num_frames"], args["object_params"]["object_num"]) == (
            ref_args["object_params"]["num_frames"], ref_args["object_params"]["object_num"])
    assert args["object_params"]["caption_style"] == "long_tail"
    dl = common.init_dataloaders(cfg)[0][0]
    assert dl.length_grouped and len(dl) == 16
    ds, tok, buckets = dl.dataset, SimpleTokenizer(), parse_text_buckets(cfg["trainer"])
    dl.set_epoch(1)
    lengths = []
    for idx in dl.batch_indices():
        batch = {"text": [ds._text(int(i), None) for i in idx],
                 "object": np.zeros((len(idx), 1, 1, 2054), np.float32),
                 "object_mask": np.ones((len(idx), 1, 1), np.float32)}
        lengths.append(prepare_batch(batch, tok, text_buckets=buckets)["input_ids"].shape[1])
    assert len(set(lengths)) >= 2 and set(lengths) <= set(buckets)
