"""The port's twelve dataset adapters (demovlp_tpu_torch.data.datasets)
against the JAX package's (demovlp_tpu.data.datasets).

* Metadata: on the committed meta_data/ files, the same length and the
  same rows, row for row (the JAX adapters read them with pandas, the port
  with the standard library), and the same label maps.
* Items: on the first rows of those files (DEMOVLP_META_DIR pointed at a
  copy), with a region tree written from a numpy seed for each item but
  one missing and one single-frame video, `get_item` under the same seeded
  generator gives bit-identical `object` / `object_mask` and equal `text`,
  `meta` and task fields, with the native reader and with numpy
  (DEMOVLP_NATIVE=0); the missing and single-frame items are resampled to
  the same substitute with the same `resample_count`.
* MSRVTT retrieval (every cut, jsfusion caption indices as an .npy array)
  and LSMDC (retrieval and multiple choice) on metadata written here: a
  numeric clip id, a numeric option column, an empty option and quoted
  fields (one over two lines, one around a tab).
* The table reader against `pd.read_csv(sep="\\t", header=None)` on every
  committed meta_data/*.tsv and on such a fixture.
Values equal with NaN equal to NaN (pandas gives NaN for an empty field).
"""
from __future__ import annotations

import json
import math
import random
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from demovlp_tpu.data.datasets import dataset_object_loader as jax_dataset
from demovlp_tpu_torch.data.datasets import DATASET_REGISTRY, dataset_object_loader
from demovlp_tpu_torch.data.datasets.table import read_table

from .test_torch_regions import write_frame

ROOT = Path(__file__).resolve().parents[1]
META = ROOT / "meta_data"
OBJ_P = {"num_frames": 3, "object_num": 6}


def eq(a, b) -> bool:
    """Equal values, NaN equal to NaN, containers element by element."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(eq(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(eq(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    try:
        if math.isnan(a) and math.isnan(b):
            return True
    except TypeError:
        pass
    return a == b


def jax_rows(ds):
    """The JAX adapter's metadata as lists: DataFrame rows (MSRVTT: [video
    id, captions]) or its list of dicts."""
    md = ds.metadata
    if isinstance(md, pd.DataFrame):
        if list(md.columns) == ["captions"]:
            return [[vid, caps] for vid, caps in zip(md.index, md["captions"])]
        return [[md.iloc[i, j] for j in range(md.shape[1])] for i in range(len(md))]
    return md


def assert_same_metadata(port, jx):
    assert len(port) == len(jx)
    assert eq(port.metadata, jax_rows(jx))
    for attr in ("ans2label", "label2ans", "qid2data", "id2answer", "id2data", "split_sizes",
                 "num_labels"):
        assert hasattr(port, attr) == hasattr(jx, attr), attr
        if hasattr(jx, attr):
            assert eq(getattr(port, attr), getattr(jx, attr)), attr


def assert_same_item(got, want):
    assert got.keys() == want.keys()
    for key in ("object", "object_mask"):
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape
        assert np.array_equal(got[key], want[key]), key
    for key in got:
        if key not in ("object", "object_mask"):
            assert eq(got[key], want[key]), key


def both(name, **kw):
    kw = {"text_params": {}, "object_params": dict(OBJ_P), **kw}
    return dataset_object_loader(name, **kw), jax_dataset(name, **kw)


# ---- committed metadata, whole files

COMMITTED = {
    "MSVDObjectSelect-train": ("MSVDObjectSelect", "train"),
    "MSVDObjectSelect-test": ("MSVDObjectSelect", "test"),
    "MSVDQAObjectSelect-val": ("MSVDQAObjectSelect", "val"),
    "MSVDQAObjectSelect-test": ("MSVDQAObjectSelect", "test"),
    "DiDeMoObjectSelect-train": ("DiDeMoObjectSelect", "train"),
    "DiDeMoObjectSelect-test": ("DiDeMoObjectSelect", "test"),
    "WebVidObjectSelect-val": ("WebVidObjectSelect", "val"),
    "ConceptualCaptions3MObjectSelect-val": ("ConceptualCaptions3MObjectSelect", "val"),
    "MSRVTTQAObjectSelect-val": ("MSRVTTQAObjectSelect", "val"),
    "MSRVTTMCObjectSelect-test": ("MSRVTTMCObjectSelect", "test"),
    "TGIFFrameObjectSelect-val": ("TGIFFrameObjectSelect", "val"),
}


@pytest.mark.parametrize("case", list(COMMITTED))
def test_committed_metadata_matches_jax(case, monkeypatch):
    monkeypatch.setenv("DEMOVLP_META_DIR", str(META))
    name, split = COMMITTED[case]
    port, jx = both(name, split=split)
    assert_same_metadata(port, jx)


@pytest.mark.parametrize("name", ["MSVDObjectSelect", "DiDeMoObjectSelect"])
def test_subsample_draws_the_rows_pandas_draws(name, monkeypatch):
    monkeypatch.setenv("DEMOVLP_META_DIR", str(META))
    np.random.seed(3)
    port = dataset_object_loader(name, text_params={}, object_params=OBJ_P, split="test",
                                 subsample=0.013)
    np.random.seed(3)
    jx = jax_dataset(name, text_params={}, object_params=OBJ_P, split="test", subsample=0.013)
    assert 0 < len(port) < 20
    assert_same_metadata(port, jx)


def test_qa_subsample_draws_the_questions_jax_draws(monkeypatch):
    monkeypatch.setenv("DEMOVLP_META_DIR", str(META))
    random.seed(4)
    port = dataset_object_loader("TGIFFrameObjectSelect", text_params={}, object_params=OBJ_P,
                                 split="val", subsample=0.01)
    random.seed(4)
    jx = jax_dataset("TGIFFrameObjectSelect", text_params={}, object_params=OBJ_P, split="val",
                     subsample=0.01)
    assert len(port) > 0
    assert_same_metadata(port, jx)


@pytest.mark.parametrize("tsv", sorted(p.name for p in META.glob("*.tsv")))
def test_committed_tsv_parses_as_pandas_does(tsv):
    df = pd.read_csv(META / tsv, sep="\t", header=None)
    rows = read_table(META / tsv)
    assert len(rows) == len(df)
    assert eq(rows, [[df.iloc[i, j] for j in range(df.shape[1])] for i in range(len(df))])


def test_table_types_as_pandas_infers_them(tmp_path):
    path = tmp_path / "t.tsv"
    path.write_text('7\t"a caption\twith a tab"\t\t1.5\tTrue\tNA\n'
                    '\n'
                    '12\tan "inner" quote\tx\t2\tFalse\t\n'
                    '  \n'
                    '3\t"runs on\nto the next line"\t\t-3e2\ttrue\t\n'
                    '4\tlast\n')
    df = pd.read_csv(path, sep="\t", header=None)
    rows = read_table(path)
    assert eq(rows, [[df.iloc[i, j] for j in range(df.shape[1])] for i in range(len(df))])
    assert [type(v) for v in rows[0][:2]] == [int, str] and isinstance(rows[0][3], float)
    assert rows[1][1] == 'an "inner" quote' and math.isnan(rows[0][2])
    named = read_table(path, names=list("abcdef"))
    assert eq(named, [[df.iloc[i, j] for j in range(6)] for i in range(len(df))])
    with pytest.raises(ValueError):
        read_table(path, names=["a", "b"])


# ---- items over region trees

def _copy_head(src: Path, dst: Path, n: int):
    """The first n rows of a split file (questions: every 37th, so that
    they span several videos); other files whole."""
    if src.suffix == ".json" and "qa_encode" in src.name:
        dst.write_text(json.dumps(json.loads(src.read_text())[::37][:n]))
    elif src.suffix == ".jsonl":
        dst.write_text("".join(src.read_text().splitlines(keepends=True)[::37][:n]))
    elif src.suffix == ".tsv":
        dst.write_text("".join(src.read_text().splitlines(keepends=True)[:n]))
    else:
        shutil.copy(src, dst)


def _frames(path: Path, n_frames: int, seed: int):
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    for f in range(n_frames):
        write_frame(path / f"{f}.npz", n=int(rng.randint(2, 10)), seed=seed * 50 + f,
                    compressed=f == 1)


ITEMS = {
    "MSVDObjectSelect": ("train", ["MSVD_train.tsv"]),
    "MSVDQAObjectSelect": ("val", ["msvd_answer_set.txt", "msvd_youtube_mapping.txt",
                                   "msvd_val_qa_encode.json"]),
    "DiDeMoObjectSelect": ("train", ["DiDeMo_train.tsv"]),
    "WebVidObjectSelect": ("val", ["webvid_validation_success_full.tsv"]),
    "ConceptualCaptions3MObjectSelect": ("val", ["cc3m_validation_success_full.tsv"]),
    "MSRVTTQAObjectSelect": ("val", ["msrvtt_qa_val.jsonl", "msrvtt_train_ans2label.json"]),
    "MSRVTTMCObjectSelect": ("test", ["msrvtt_mc_test.jsonl"]),
    "TGIFFrameObjectSelect": ("val", ["frameqa_val.jsonl", "frameqa_trainval_ans2label.json"]),
}
N_ROWS = 8
MISSING, SINGLE = 2, 5  # rows without regions and with one frame


def _tree(tmp_path, monkeypatch, name):
    """Metadata heads of N_ROWS rows and a region tree for them."""
    split, files = ITEMS[name]
    meta = tmp_path / "meta"
    meta.mkdir()
    for f in files:
        _copy_head(META / f, meta / f, N_ROWS)
    monkeypatch.setenv("DEMOVLP_META_DIR", str(meta))
    kw = dict(split=split, object_dir=str(tmp_path / "objects"))
    port = dataset_object_loader(name, text_params={}, object_params=OBJ_P, **kw)
    paths = list(dict.fromkeys(Path(port._object_path(i)) for i in range(len(port))))
    assert len(paths) > SINGLE
    for i, path in enumerate(paths):
        if i == MISSING:
            continue
        if name == "ConceptualCaptions3MObjectSelect":
            path.parent.mkdir(parents=True, exist_ok=True)
            write_frame(path if i % 2 else path.with_name(path.name.replace("_1.npz", "_0.npz")),
                        n=4 + i, seed=i)
        else:
            n_frames = 1 if i == SINGLE else (OBJ_P["num_frames"] if i == 3 else 2 + i)
            _frames(path, n_frames, seed=i)
    return kw


@pytest.mark.parametrize("reader", ["native", "numpy"])
@pytest.mark.parametrize("name", list(ITEMS))
def test_items_match_jax(tmp_path, monkeypatch, name, reader):
    if reader == "numpy":
        monkeypatch.setenv("DEMOVLP_NATIVE", "0")
    kw = _tree(tmp_path, monkeypatch, name)
    port, jx = both(name, **kw)
    assert_same_metadata(port, jx)
    assert len(port) == N_ROWS
    for i in range(len(port)):
        for seed in (0, 1):
            assert_same_item(port.get_item(i, np.random.default_rng(seed)),
                             jx.get_item(i, np.random.default_rng(seed)))
    assert_same_item(port[11], jx[11])
    assert port.resample_count == jx.resample_count
    if name != "ConceptualCaptions3MObjectSelect":
        assert port.resample_count > 0  # the missing and single-frame rows
    assert np.array_equal(port.text_lengths(), jx.text_lengths())


@pytest.mark.parametrize("name", ["MSVDObjectSelect", "TGIFFrameObjectSelect"])
def test_plan_item_draws_as_get_item(tmp_path, monkeypatch, name):
    kw = _tree(tmp_path, monkeypatch, name)
    port, jx = both(name, **kw)
    for i in range(len(port)):
        paths, data = port.plan_item(i, np.random.default_rng(i))
        jpaths, jdata = jx.plan_item(i, np.random.default_rng(i))
        assert paths == jpaths and eq(data, jdata)
        item = port.get_item(i, np.random.default_rng(i))
        assert eq({k: v for k, v in item.items() if k in data}, data)
        assert_same_item(item, jx.get_item(i, np.random.default_rng(i)))
    assert port.resample_count == jx.resample_count > 0


def test_registry_builds_all_twelve(monkeypatch):
    assert len(DATASET_REGISTRY) == 12
    monkeypatch.setenv("DEMOVLP_META_DIR", str(META))
    for name, split in COMMITTED.values():
        assert len(dataset_object_loader(name, text_params={}, object_params=OBJ_P,
                                         split=split)) > 0
    with pytest.raises(NotImplementedError):
        dataset_object_loader("NoSuchDataset", text_params={}, object_params=OBJ_P)


# ---- MSRVTT retrieval and LSMDC on metadata written here

CUT_LISTS = {
    "miech": ("train_list_miech.txt", "test_list_miech.txt"),
    "jsfusion": ("train_list_jsfusion.txt", "val_list_jsfusion.txt"),
    "full-val": ("train_list_full.txt", "val_list_full.txt"),
    "full-test": ("train_list_full.txt", "test_list_full.txt"),
    "val": ("train_list.txt", "val_list.txt"),
    "public_server_val": ("train_list.txt", "public_server_val.txt"),
    "public_server_test": ("train_list.txt", "public_server_test.txt"),
}


@pytest.fixture()
def msrvtt(tmp_path):
    meta = tmp_path / "meta"
    (meta / "annotation").mkdir(parents=True)
    splits = meta / "high-quality" / "structured-symlinks"
    splits.mkdir(parents=True)
    vids = [f"video{i}" for i in (3, 11, 0, 7, 25, 9, 14)]
    rng = np.random.RandomState(0)
    anns = [{"image_id": v, "caption": f"caption {c} of {v}", "id": k}
            for k, (v, c) in enumerate((vids[int(rng.randint(len(vids)))], c)
                                       for c in range(30))]
    anns.append({"image_id": "video99", "caption": "outside every split"})
    (meta / "annotation" / "MSR_VTT.json").write_text(json.dumps({"annotations": anns}))
    for train, test in CUT_LISTS.values():
        (splits / train).write_text("\n".join(vids[:4]) + "\n")
        (splits / test).write_text("\n".join(vids[4:]) + "\n")
    have = sorted({a["image_id"] for a in anns} & set(vids[4:]))
    np.save(splits / "jsfusion_val_caption_idx.npy", np.zeros(len(have), dtype=np.int64))
    (splits / "jsfusion_val_caption_idx.npy").rename(splits / "jsfusion_val_caption_idx.pkl")
    objects = tmp_path / "objects"
    for i, v in enumerate(vids):
        if i != 1:
            _frames(objects / v, 3 + i % 3, seed=40 + i)
    return dict(metadata_dir=str(meta), object_dir=str(objects))


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("cut", list(CUT_LISTS))
def test_msrvtt_retrieval_cuts(msrvtt, cut, split):
    port, jx = both("MSRVTTObjectSelect", cut=cut, split=split, **msrvtt)
    assert_same_metadata(port, jx)
    assert len(port) > 0
    for i in range(len(port) + 2):
        assert_same_item(port.get_item(i, np.random.default_rng(i)),
                         jx.get_item(i, np.random.default_rng(i)))
    assert port.resample_count == jx.resample_count
    assert np.array_equal(port.text_lengths(), jx.text_lengths())


def test_msrvtt_refuses_a_pickled_caption_index(msrvtt):
    import pickle

    path = Path(msrvtt["metadata_dir"]) / "high-quality/structured-symlinks"
    (path / "jsfusion_val_caption_idx.pkl").write_bytes(pickle.dumps([0, 1]))
    with pytest.raises(ValueError, match="jsfusion_val_caption_idx.pkl"):
        dataset_object_loader("MSRVTTObjectSelect", text_params={}, object_params=OBJ_P,
                              cut="jsfusion", split="test", **msrvtt)
    with pytest.raises(ValueError, match="unrecognised"):
        dataset_object_loader("MSRVTTObjectSelect", text_params={}, object_params=OBJ_P,
                              cut="other", split="test", **msrvtt)


@pytest.fixture()
def lsmdc(tmp_path):
    meta = tmp_path / "data" / "meta_data"
    meta.mkdir(parents=True)
    clips = ["0001_American_Beauty_00.00.51.926-00.00.54.129",
             "0001_American_Beauty_00.00.56.224-00.00.57.879",
             "1004_Juno_00.01.02.311-00.01.05.116",
             "1004_Juno_00.01.09.500-00.01.11.041"]
    caption = ['Someone sits.', '"A quoted caption\nover two lines"', 'Someone "quotes".',
               'SOMEONE smiles.']
    retrieval = "".join(f"{c}\t{i}\t{i + 1}\t{i}\t{i}\t{cap}\n"
                        for i, (c, cap) in enumerate(zip(clips, caption)))
    (meta / "LSMDC16_annos_training.csv").write_text(retrieval)
    (meta / "LSMDC16_challenge_1000_publictect.csv").write_text(
        retrieval + "2001\t1\t2\t3\t4\t1234\n")
    # option a is numeric (an int reaches text and meta), option b of clip 1
    # is empty (NaN), option c is quoted around a tab
    mc = "".join(f"{c}\t{i}\t0\t0\tdesc\t{10 + i}\t{'' if i == 1 else 'opt b'}\t\"opt\tc\"\t"
                 f"opt d\topt e\t{1 + i % 5}\n" for i, c in enumerate(clips))
    for f in ("LSMDC16_multiple_choice_train.csv",
              "LSMDC16_multiple_choice_test_randomized.csv"):
        (meta / f).write_text(mc)
    objects = tmp_path / "objects"
    for i, c in enumerate(clips):
        from demovlp_tpu_torch.data.datasets.lsmdc import _movie_rel_path

        _frames(objects / _movie_rel_path(c), 3, seed=60 + i)
    return dict(data_dir=str(tmp_path / "data"), object_dir=str(objects))


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("name", ["LSMDCObjectSelect", "LSMDCMCObjectSelect"])
def test_lsmdc(lsmdc, name, split):
    port, jx = both(name, split=split, **lsmdc)
    assert_same_metadata(port, jx)
    n = len(port) - (name == "LSMDCObjectSelect" and split == "test")  # 2001 has no regions
    for i in range(n):
        assert_same_item(port.get_item(i, np.random.default_rng(i)),
                         jx.get_item(i, np.random.default_rng(i)))
    if name == "LSMDCMCObjectSelect":
        assert math.isnan(port.metadata[1]["options"][1])  # the empty option
        assert port.metadata[0]["options"][2] == "opt\tc"
        assert port.metadata[2]["options"][0] == 12 and type(port.metadata[2]["options"][0]) is int
        assert port.get_item(2, np.random.default_rng(0))["meta"]["raw_captions"] == 12
        assert [d["answer"] for d in port.metadata] == (
            [0, 1, 2, 3] if split == "test" else [0] * 4)
    else:
        assert port.metadata[1][-1] == "A quoted caption\nover two lines"
        assert port.metadata[2][-1] == 'Someone "quotes".'
        if split == "test":
            assert port.metadata[-1][0] == "2001" and port._text(len(port) - 1, None) == "1234"
