"""Free-text query serving, on the CPU, against the JAX package:
configs/smoke/synthetic_retrieval.json with the same perturbed weights on
both sides (the JAX params carried across with `from_jax`, or written as a
reference-schema `.pth` for the CLIs); one gallery for both, the port's
`embed_loader` over the test split (tests/test_torch_serve.py holds it to
the JAX one).

* `embed_texts` against the JAX `embed_texts` (batches of 3 over 7 queries,
  so the last batch is padded): rtol 1e-4 / atol 1e-5, the embedding
  tolerance of tests/test_torch_serve.py.
* `query_retrieval` against the JAX `query_retrieval` (its XLA local form
  on the CPU), with and without the local sims, focal 'prob' and 'equal',
  one query and several, and under the MSCOCO every-5th-row dedup: the
  (query, gallery) sims at atol 5e-4, the tolerance tests/test_torch_serve.py
  holds the combined sims to against the XLA form; the top-k indices equal
  at every rank whose score is more than twice that from its neighbours'.
* The query CLI end to end on an index the port's extraction CLI wrote.
"""
from __future__ import annotations

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from demovlp_tpu import serve as jserve
from demovlp_tpu.cli.common import build_model, init_dataloaders
from demovlp_tpu.config import ConfigParser as JaxConfig
from demovlp_tpu.convert.torch_export import save_reference_checkpoint
from demovlp_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer
from demovlp_tpu.parallel import create_mesh
from demovlp_tpu.train.steps import prepare_batch as jax_prepare_batch
from demovlp_tpu_torch import serve
from demovlp_tpu_torch.cli import common
from demovlp_tpu_torch.cli.extract_embeddings import run as extract_run
from demovlp_tpu_torch.cli.query_index import run as query_run
from demovlp_tpu_torch.convert.from_jax import from_jax
from demovlp_tpu_torch.data.tokenizer import SimpleTokenizer

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ROOT / "configs" / "smoke" / "synthetic_retrieval.json"
EMBED_TOL = dict(rtol=1e-4, atol=1e-5)
SIMS_ATOL = 5e-4
FREE_TEXT = ["a dog runs in the park", "", "red car street video shows music group walking "
             "man woman child ball game water tree house", "the"]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("query")
    cfg = json.loads(SMOKE.read_text())
    mesh = create_mesh(devices=jax.devices()[:1])
    jmodel = build_model(JaxConfig(config=cfg, test=True))
    dl = init_dataloaders(JaxConfig(config=cfg, test=True), val_split="test", train=False)[1][0]
    arrays = jax_prepare_batch(next(iter(dl)), JaxTokenizer())
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), {k: arrays[k] for k in (
        "input_ids", "attention_mask", "object", "object_mask")})
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.randn(*np.shape(x)).astype(np.float32), params)
    model = common.build_model(cfg)
    model.load_state_dict(from_jax(params), strict=True)
    tdl = common.init_dataloaders(cfg, val_split="test", train=False)[1][0]
    cat, meta = serve.embed_loader(serve.make_embed_step(model), tdl, SimpleTokenizer(), "cpu")
    pth = tmp / "weights.pth"
    save_reference_checkpoint(str(pth), params)
    return dict(cfg=cfg, mesh=mesh, jmodel=jmodel, params=params, cat=cat, meta=meta,
                jstep=jserve.make_text_embed_step(jmodel, mesh),
                tstep=serve.make_text_embed_step(model), pth=pth, tmp=tmp)


def _queries(both, n):
    return (list(both["meta"]["raw_captions"][:3]) + FREE_TEXT)[:n]


def test_embed_texts_match(both):
    queries = _queries(both, 7)
    want = jserve.embed_texts(both["jstep"], both["params"], queries, JaxTokenizer(),
                              both["mesh"], batch_size=3)
    got = serve.embed_texts(both["tstep"], queries, SimpleTokenizer(), "cpu", batch_size=3)
    assert set(got) == set(want) == {"g_t", "l_t", "t_mask"}
    for k in want:
        assert got[k].shape == want[k].shape and got[k].shape[0] == len(queries), k
        np.testing.assert_allclose(got[k], np.asarray(want[k], np.float32), err_msg=k,
                                   **EMBED_TOL)
    # the gallery's own captions embed as the gallery's text rows
    np.testing.assert_allclose(got["g_t"][:3], both["cat"]["g_t"][:3], **EMBED_TOL)


def _jax_sims(results, n_gallery):
    sims = np.full((len(results), n_gallery), np.nan, np.float32)
    for q, r in enumerate(results):
        sims[q, r["topk_indices"]] = r["topk_scores"]
    return sims


@pytest.mark.parametrize("use_local,focal,n_queries,dedup", [
    (True, "equal", 1, False),
    (True, "equal", 5, False),
    (True, "prob", 1, False),
    (True, "prob", 5, False),
    (False, "equal", 1, False),
    (False, "prob", 5, False),
    (True, "equal", 5, True),
], ids=["local-equal-1q", "local-equal-5q", "local-prob-1q", "local-prob-5q",
        "global-1q", "global-5q", "mscoco-dedup"])
def test_query_retrieval_matches_jax(both, use_local, focal, n_queries, dedup):
    queries = _queries(both, n_queries)
    cat, meta = both["cat"], both["meta"]
    n_gal = len(cat["g_o"][::5]) if dedup else len(cat["g_o"])
    kw = dict(use_local=use_local, lambda_softmax=20.0, focal_type=focal,
              mscoco_dedup=dedup, gallery_meta=meta)
    want = jserve.query_retrieval(both["jstep"], both["params"], queries, JaxTokenizer(), cat,
                                  both["mesh"], k=n_gal, backend="xla", **kw)
    got, sims = serve.query_retrieval(both["tstep"], queries, SimpleTokenizer(), cat, "cpu",
                                      k=n_gal, **kw)
    step = 5 if dedup else 1
    want_sims = _jax_sims([dict(r, topk_indices=[i // step for i in r["topk_indices"]])
                           for r in want], n_gal)
    assert sims.shape == (len(queries), n_gal)
    np.testing.assert_allclose(sims, want_sims, rtol=0, atol=SIMS_ATOL)
    for g, w in zip(got, want, strict=True):
        assert g["query_caption"] == w["query_caption"]
        assert all(i % step == 0 for i in g["topk_indices"])
        scores = np.asarray(w["topk_scores"])
        gaps = np.abs(np.diff(scores))
        for r in range(len(scores)):
            apart = all(gaps[j] > 2 * SIMS_ATOL for j in (r - 1, r) if 0 <= j < len(gaps))
            if apart:
                assert g["topk_indices"][r] == w["topk_indices"][r], (r, g, w)
                assert g["topk_paths"][r] == w["topk_paths"][r]


def test_query_cli_on_extracted_index(both):
    tmp, pth = both["tmp"], both["pth"]
    index = tmp / "index.npz"
    extract_run(["-c", str(SMOKE), "-r", str(pth), "--split", "test", "--output", str(index),
                 "--device", "cpu"])
    qfile = tmp / "queries.txt"
    qfile.write_text("\n".join(["a person plays ball", "", "blue water tree"]) + "\n")
    out = tmp / "results.json"
    rec = query_run(["-c", str(SMOKE), "-r", str(pth), "--index", str(index),
                     "--query", "a dog runs", "--query", "small cat jumps",
                     "--queries-file", str(qfile), "-k", "4", "--output", str(out),
                     "--device", "cpu"])
    results = json.loads(out.read_text())
    queries = ["a dog runs", "small cat jumps", "a person plays ball", "blue water tree"]
    assert [r["query_caption"] for r in results] == queries
    assert all(len(r["topk_indices"]) == 4 and len(r["topk_paths"]) == 4 for r in results)
    assert rec["sims"].shape == (4, 32) and rec["seconds"] > 0
    # the same scoring as the JAX package over the JAX-built gallery
    want = jserve.query_retrieval(both["jstep"], both["params"], queries, JaxTokenizer(),
                                  both["cat"], both["mesh"], k=32, use_local=True,
                                  lambda_softmax=20.0, focal_type="equal", backend="xla")
    np.testing.assert_allclose(rec["sims"], _jax_sims(want, 32), rtol=0, atol=SIMS_ATOL)
    assert [r["topk_scores"] for r in results] == [
        [float(rec["sims"][q, i]) for i in r["topk_indices"]] for q, r in enumerate(results)]


def test_query_cli_needs_a_query(both, capsys):
    with pytest.raises(SystemExit):
        query_run(["-c", str(SMOKE), "--index", str(both["tmp"] / "none.npz"),
                   "--device", "cpu"])
    assert "no queries" in capsys.readouterr().err


def test_query_cli_raises_without_a_card(both, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        query_run(["-c", str(SMOKE), "--index", str(both["tmp"] / "none.npz"),
                   "--query", "a dog"])
