"""The port's parallel layer without processes, against the JAX package.

* The host gathers with a simulated allgather (one call per gather,
  returning what P processes would contribute), as
  tests/test_multihost_eval.py drives the JAX ones: ragged arrays with
  unequal counts, python lists with an empty shard, and MC predictions;
  each equal to the JAX function's result on the same inputs.
* The loader shards: for each (seed, epoch, P, p) the port's
  `host_indices` and batches equal the JAX `RegionDataLoader`'s
  (`_host_indices`, its iterated batches' samples and `sample_valid`
  flags) for train (shuffled, dropping the remainder; with and without
  length grouping) and eval (contiguous shares with the cyclic wrap), and
  `len` agrees.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

from demovlp_tpu.data.datasets import dataset_object_loader as jax_dataset
from demovlp_tpu.data.loader import RegionDataLoader as JaxLoader
from demovlp_tpu.parallel import mesh as jmesh
from demovlp_tpu.train.mc import merge_mc_predictions as jax_merge
from demovlp_tpu_torch.data.datasets import dataset_object_loader
from demovlp_tpu_torch.data.loader import RegionDataLoader
from demovlp_tpu_torch.parallel import mesh
from demovlp_tpu_torch.train.mc import merge_mc_predictions

F, K = 2, 4


def _fake_allgather(per_process_calls):
    """Each call returns the concatenation of what every process passes."""
    calls = list(per_process_calls)

    def gather(x):
        return np.concatenate(calls.pop(0), axis=0)

    return gather


def _ragged_calls(shards):
    cap = max(len(s) for s in shards)
    padded = [np.concatenate([s, np.zeros((cap - len(s),) + s.shape[1:], s.dtype)])
              for s in shards]
    return [[np.asarray([len(s)], np.int64) for s in shards], padded]


@pytest.mark.parametrize("counts", [(4, 3, 3), (2, 0, 5), (3, 3)])
def test_host_allgather_ragged_matches_jax(counts):
    rng = np.random.default_rng(sum(counts))
    shards = [rng.standard_normal((c, 3)).astype(np.float32) for c in counts]
    want = np.concatenate(shards)
    got = mesh.host_allgather_ragged(shards[0], allgather=_fake_allgather(_ragged_calls(shards)))
    ref = jmesh.host_allgather_ragged(shards[0], allgather=_fake_allgather(_ragged_calls(shards)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)


def test_host_allgather_pylist_matches_jax():
    lists = [["a/b.mp4", "a caption, with commas"], ["unicode éè"], []]
    payloads = [np.frombuffer(json.dumps(x).encode("utf-8"), np.uint8) for x in lists]
    calls = _ragged_calls(payloads)
    got = mesh.host_allgather_pylist(lists[0], allgather=_fake_allgather(calls))
    ref = jmesh.host_allgather_pylist(lists[0], allgather=_fake_allgather(_ragged_calls(payloads)))
    assert got == ref == [s for x in lists for s in x]


def test_one_process_gathers_return_their_input():
    x = np.arange(6).reshape(3, 2)
    np.testing.assert_array_equal(mesh.host_allgather_ragged(x), x)
    assert mesh.host_allgather_pylist(["a"]) == ["a"]
    assert mesh.host_allgather(x) is x
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    assert mesh.data_coords(None) == (0, 1) and mesh.data_allgather(None) is None


def test_merge_mc_predictions_matches_jax():
    ids = [f"q{i}" for i in range(7)]
    per_host = [{"q0": 1, "q1": 3, "q2": 0}, {"q3": 2, "q4": 4}, {"q5": 1, "q6": 0}]
    idx = [np.asarray([ids.index(k) for k in p], np.int64) for p in per_host]
    pred = [np.asarray(list(p.values()), np.int64) for p in per_host]
    cap = max(len(i) for i in idx)

    def calls():
        pad = [np.concatenate([a, np.full(cap - len(a), -1, np.int64)]) for a in idx]
        padp = [np.concatenate([a, np.full(cap - len(a), -1, np.int64)]) for a in pred]
        return [[np.asarray([len(a)], np.int64) for a in idx], pad, padp]

    got = merge_mc_predictions(per_host[0], ids, allgather=_fake_allgather(calls()))
    ref = jax_merge(per_host[0], ids, allgather=_fake_allgather(calls()))
    assert got == ref == {k: v for p in per_host for k, v in p.items()}
    with pytest.raises(KeyError):
        merge_mc_predictions({"zz": 1}, ids)


# ------------------------------------------------------------------ loaders
def _datasets(n):
    kw = dict(text_params={}, split="test",
              object_params={"num_frames": F, "object_num": K, "num_samples": n,
                             "caption_style": "long_tail"})
    return (dataset_object_loader("SyntheticObjectSelect", **kw),
            jax_dataset("SyntheticObjectSelect", **kw))


SHARDS = [
    # (n, batch, P, p, train, length_grouped, seed, epoch)
    (23, 4, 2, 1, True, False, 0, 1),
    (23, 4, 2, 0, True, True, 3, 2),
    (40, 3, 4, 3, True, True, 5, 1),
    (21, 4, 4, 3, False, False, 0, 0),
    (21, 4, 4, 0, False, False, 0, 0),
    (3, 2, 8, 5, False, False, 0, 0),
    (20, 8, 2, 1, False, False, 0, 0),
]


@pytest.mark.parametrize("n,bs,P,p,train,grouped,seed,epoch", SHARDS)
def test_loader_shards_match_jax(n, bs, P, p, train, grouped, seed, epoch):
    tds, jds = _datasets(n)
    kw = dict(batch_size=bs, shuffle=train, num_workers=1, drop_last=train, seed=seed,
              process_index=p, process_count=P, length_grouped=grouped)
    tdl = RegionDataLoader(tds, **kw)
    jdl = JaxLoader(jds, **kw)
    for dl in (tdl, jdl):
        dl.set_epoch(epoch)
    t_idx, t_valid = tdl.host_indices()
    j_idx, j_valid = jdl._host_indices()
    np.testing.assert_array_equal(t_idx, j_idx)
    assert (t_valid is None) == (j_valid is None)
    if t_valid is not None:
        np.testing.assert_array_equal(t_valid, j_valid)
    assert len(tdl) == len(jdl)
    t_batches, j_batches = list(tdl), list(jdl)
    assert len(t_batches) == len(j_batches) == len(tdl)
    for tb, jb in zip(t_batches, j_batches):
        assert [m["raw_captions"] for m in tb["meta"]] == [m["raw_captions"] for m in jb["meta"]]
        np.testing.assert_array_equal(tb["object"], jb["object"])
        assert ("sample_valid" in tb) == ("sample_valid" in jb)
        if "sample_valid" in tb:
            np.testing.assert_array_equal(tb["sample_valid"], jb["sample_valid"])


def test_eval_shards_cover_every_sample_once():
    n, P = 21, 4
    tds, _ = _datasets(n)
    seen = []
    for p in range(P):
        idx, valid = RegionDataLoader(tds, batch_size=4, process_index=p,
                                      process_count=P).host_indices()
        seen.extend(np.asarray(idx)[valid].tolist())
    assert seen == list(range(n))


def test_loader_refuses_a_bad_shard():
    tds, _ = _datasets(4)
    with pytest.raises(ValueError):
        RegionDataLoader(tds, batch_size=2, process_index=2, process_count=2)
    with pytest.raises(ValueError):
        RegionDataLoader(tds, batch_size=2, shuffle=True, drop_last=True, process_index=0,
                         process_count=8).host_indices()
