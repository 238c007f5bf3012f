"""Video-QA prediction, on the CPU, against the JAX package:
configs/smoke/synthetic_qa.json over a 29-question test split (a partial
last batch, so pad rows must be dropped), the JAX ObjectQARelation's
params carried across with `from_jax` (written as a reference-schema
`.pth` for the CLI).

* `predict_qa` against the JAX `predict_qa`: identical question ids and
  answers, answer texts from `label2ans`, every question exactly once.
* The predict CLI writes the same list as JSON, and without `--device cpu`
  on a machine with no card it raises before writing anything.
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
from demovlp_tpu.train.steps import make_qa_eval_step as jax_qa_eval_step
from demovlp_tpu.train.steps import prepare_batch as jax_prepare_batch
from demovlp_tpu_torch import serve
from demovlp_tpu_torch.cli import common
from demovlp_tpu_torch.cli.predict_qa import run
from demovlp_tpu_torch.convert.from_jax import from_jax
from demovlp_tpu_torch.data.tokenizer import SimpleTokenizer
from demovlp_tpu_torch.train.steps import make_qa_eval_step

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ROOT / "configs" / "smoke" / "synthetic_qa.json"
N_QUESTIONS = 29


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("predict_qa")
    cfg = json.loads(SMOKE.read_text())
    cfg["data_loader"]["args"]["object_params"]["num_samples"] = N_QUESTIONS
    cfg_path = tmp / "qa.json"
    cfg_path.write_text(json.dumps(cfg))
    config = JaxConfig(config=cfg, test=True)
    mesh = create_mesh(devices=jax.devices()[:1])
    jmodel = build_model(config)
    dl = init_dataloaders(config, val_split="test", train=False)[1][0]
    arrays = jax_prepare_batch(next(iter(dl)), JaxTokenizer())
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), {k: arrays[k] for k in (
        "input_ids", "attention_mask", "object", "object_mask")})
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + np.asarray(0.05 * rng.randn(*np.shape(x)), np.float32), params)
    want = jserve.predict_qa(jax_qa_eval_step(jmodel, mesh), params, dl, JaxTokenizer(), mesh,
                             label2ans=dl.dataset.label2ans)
    model = common.build_model(cfg)
    model.load_state_dict(from_jax(params), strict=True)
    tdl = common.init_dataloaders(cfg, val_split="test", train=False)[1][0]
    got = serve.predict_qa(make_qa_eval_step(model), tdl, SimpleTokenizer(), "cpu",
                           label2ans=tdl.dataset.label2ans)
    pth = tmp / "weights.pth"
    save_reference_checkpoint(str(pth), params)
    return dict(want=want, got=got, cfg_path=cfg_path, pth=pth, tmp=tmp, n_batches=len(tdl),
                label2ans=tdl.dataset.label2ans)


def test_predictions_match_jax(both):
    got, want = both["got"], both["want"]
    assert both["n_batches"] == 4  # three full batches of 8 and one of 5
    assert [r["question_id"] for r in got] == [r["question_id"] for r in want]
    assert [r["answer"] for r in got] == [r["answer"] for r in want]
    assert [r["answer_text"] for r in got] == [both["label2ans"][r["answer"]] for r in got]
    assert sorted(r["question_id"] for r in got) == list(range(N_QUESTIONS))
    assert len({r["answer"] for r in got}) > 1  # not one constant answer


def test_predict_cli_writes_json(both):
    out = both["tmp"] / "pred.json"
    recs = run(["-c", str(both["cfg_path"]), "-r", str(both["pth"]), "--output", str(out),
                "--device", "cpu"])
    assert len(recs) == 1 and recs[0]["path"] == out
    written = json.loads(out.read_text())
    assert written == recs[0]["results"] == [
        {"question_id": r["question_id"], "answer": r["answer"], "answer_text": r["answer_text"]}
        for r in both["want"]]


def test_predict_cli_raises_without_a_card(both, monkeypatch):
    out = both["tmp"] / "none.json"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(["-c", str(both["cfg_path"]), "--output", str(out)])
    assert not out.exists()
