"""The serving slice as a whole: the port's extraction CLI (`--device cpu`)
against the JAX package's `serve.embed_loader` + `combined_sims` on a
1-device CPU mesh, on configs/smoke/synthetic_retrieval.json with the same
weights (the JAX params written as a reference-schema `.pth` and read by
the port's `-r`).

On the card the JAX package scores the local sims with its Pallas kernel,
and so does the port (with its CUDA kernel); on the CPU the JAX
`combined_sims` takes its XLA form instead. That form adds the -100 query
mask of padded caption words before exp(20 a), and at -2000 the f32 ulp is
1.2e-4, so 20 a loses about 1e-4 there; under focal 'equal' that can flip
the above-the-mean threshold of a near-tie position.

Tolerances: embeddings rtol 1e-4 / atol 1e-5 (f32 towers, summation order
only). Combined sims against the JAX global sims plus the Pallas kernel in
interpret mode: rtol 1e-4 / atol 2e-5, the kernel tolerance of
tests/test_pallas.py. Against the XLA-form `combined_sims`: atol 5e-4, for
the threshold flips above (measured 2.4e-4 on this config). Top-k equal.
"""
from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from demovlp_tpu import serve as jserve
from demovlp_tpu.cli.common import build_model, init_dataloaders
from demovlp_tpu.config import ConfigParser as JaxConfig
from demovlp_tpu.convert.torch_export import save_reference_checkpoint
from demovlp_tpu.data.datasets import dataset_object_loader as jax_dataset
from demovlp_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer
from demovlp_tpu.ops.pallas_xattn import xattn_score_pallas_interpret
from demovlp_tpu.ops.similarity import sim_matrix
from demovlp_tpu.parallel import create_mesh
from demovlp_tpu_torch.cli.extract_embeddings import run
from demovlp_tpu_torch.data.datasets import dataset_object_loader
from demovlp_tpu_torch.data.tokenizer import SimpleTokenizer
from demovlp_tpu_torch.serve import EMBED_KEYS, load_index

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ROOT / "configs" / "smoke" / "synthetic_retrieval.json"


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    cfg = json.loads(SMOKE.read_text())
    config = JaxConfig(config=cfg, test=True)
    mesh = create_mesh(devices=jax.devices()[:1])
    model = build_model(config)
    _, loaders = init_dataloaders(config, val_split="test", train=False)
    dl = loaders[0]
    template = next(iter(dl))
    from demovlp_tpu.train.steps import prepare_batch

    arrays = prepare_batch(template, JaxTokenizer())
    params = model.init(jax.random.PRNGKey(0), {k: arrays[k] for k in (
        "input_ids", "attention_mask", "object", "object_mask")})
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.randn(*np.shape(x)).astype(np.float32),
        params,
    )
    cat, meta = jserve.embed_loader(jserve.make_embed_step(model, mesh), params, dl,
                                    JaxTokenizer(), mesh)
    sims = jserve.combined_sims(cat, mesh, use_local=True, lambda_softmax=20.0,
                                focal_type="equal", backend="xla")
    kernel_sims = np.asarray(sim_matrix(jnp.asarray(cat["g_t"]), jnp.asarray(cat["g_o"])))
    kernel_sims = kernel_sims + np.asarray(xattn_score_pallas_interpret(
        *(jnp.asarray(cat[k], jnp.float32) for k in ("l_o", "l_t", "o_mask", "t_mask")),
        20.0, "equal"))
    want_results = jserve.topk_retrieval(sims, k=5, query_meta=meta, gallery_meta=meta)
    pth = tmp / "weights.pth"
    save_reference_checkpoint(str(pth), params)
    rec = run(["-c", str(SMOKE), "-r", str(pth), "--split", "test",
               "--output", str(tmp / "emb.npz"), "--topk", "5",
               "--results", str(tmp / "r.json"), "--device", "cpu"])
    assert len(rec) == 1
    return dict(cat=cat, meta=meta, sims=sims, kernel_sims=kernel_sims,
                results=want_results, port=rec[0], tmp=tmp)


def test_embeddings_match(both):
    port, cat = both["port"]["cat"], both["cat"]
    assert set(port) == set(EMBED_KEYS)
    for k in EMBED_KEYS:
        assert port[k].shape == cat[k].shape, k
        np.testing.assert_allclose(port[k], np.asarray(cat[k], port[k].dtype),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    assert both["port"]["meta"] == both["meta"]


def test_combined_sims_and_topk_match(both):
    got_sims = both["port"]["sims"]
    np.testing.assert_allclose(got_sims, both["kernel_sims"], rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(got_sims, both["sims"], rtol=0, atol=5e-4)
    got = [r["topk_indices"] for r in both["port"]["results"]]
    want = [r["topk_indices"] for r in both["results"]]
    assert got == want


def test_cli_outputs_written(both):
    cat, meta = load_index(both["tmp"] / "emb.npz")
    for k in EMBED_KEYS:
        np.testing.assert_array_equal(cat[k], both["port"]["cat"][k])
    assert meta == both["port"]["meta"]
    results = json.loads((both["tmp"] / "r.json").read_text())
    assert [r["topk_indices"] for r in results] == [
        r["topk_indices"] for r in both["port"]["results"]]


@pytest.mark.parametrize("style", ["short", "long_tail"])
def test_synthetic_samples_bit_identical(style):
    params = dict(num_frames=8, object_num=30, num_samples=5, task="retrieval",
                  caption_style=style)
    jds = jax_dataset("SyntheticObjectSelect", text_params={}, object_params=params,
                      split="test")
    tds = dataset_object_loader("SyntheticObjectSelect", text_params={},
                                object_params=params, split="test")
    for i in range(len(jds)):
        a, b = jds[i], tds[i]
        np.testing.assert_array_equal(a["object"], b["object"])
        np.testing.assert_array_equal(a["object_mask"], b["object_mask"])
        assert a["object_len"] == b["object_len"]
        assert a["text"] == b["text"] and a["meta"] == b["meta"]
        jt, tt = JaxTokenizer()(a["text"]), SimpleTokenizer()(b["text"])
        for k in jt:
            np.testing.assert_array_equal(jt[k], tt[k])
