"""Data parallelism over torch.distributed, on the CPU: two gloo processes
(tests/torch_dist_worker.py, each killed after 120 s) at a tiny width,
f32, dropout off, held against one process on the concatenated batch.

* Train steps (retrieval; retrieval with `max_grad_norm`, which clips the
  summed gradient; retrieval with the MLM loss, normalised by the global
  count of masked tokens; QA, whose cross-entropy is a mean over the
  global batch): two steps of 4 rows a rank against two steps of 8 rows.
  The losses within 1e-5 relative. Every gradient of step 1 within
  1e-4 of its tensor's largest |value| + 1e-6 (the 1e-6 floor covers a
  key bias, whose gradient is zero in theory and rounding noise on both
  sides). The parameters after step 2 the same, except that Adam's first
  updates are close to lr * sign(g): an element whose gradient is within
  rounding of zero may move by up to 2 lr in one run and not the other,
  so at most 0.5% of the elements may lie beyond, each within 2 lr + 1e-6
  (as tests/test_torch_train.py holds the port to JAX).
* Eval: the val loss of a global batch whose pad rows are flagged invalid
  equals the one-process loss over its valid rows alone; `embed_loader`
  over a 9-sample loader split 5 + 4 (+ 1 wrapped duplicate) gathers the
  one-process embeddings and metadata in dataset order, and the combined
  sims with split gallery rows equal the one-process sims (rtol 1e-5 and
  atol 1e-5 of the array's largest |value|: the towers' products run on
  4 rows in place of 8).
* Text buckets: two ranks whose longest captions fall in different
  buckets trim to the larger one.
* Checkpoints: rank 0 writes, both ranks restore, and a step from the
  restored state equals a step from the live one on every rank.
* Dropout (on, fed the same rows on both ranks): two data ranks draw
  different masks, and the two ranks of one model group (mesh (1, 2), one
  data rank) the same masks, as their replicated activations need.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from tests import torch_dist_worker as W
from demovlp_tpu_torch.cli.common import build_optimizer
from demovlp_tpu_torch.losses.losses import CrossEntropy
from demovlp_tpu_torch.train.steps import (make_qa_train_step, make_retrieval_eval_step,
                                           make_retrieval_train_step)

LR = 1e-3
CASES = ("plain", "clip", "mlm", "qa")


def _init():
    return {"retrieval": W.tiny_model().state_dict(), "mlm": W.tiny_model(mlm=True).state_dict(),
            "qa": W.tiny_model("qa").state_dict()}


def _ranks(out, world: int = 2):
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dp"))
    init = _init()
    W.spawn(W.dp_cases, 2, out, init)
    return init, _ranks(out)


def close_tensors(ref, got, lr=None):
    """Each tensor within 1e-4 of its largest |value| + 1e-6; with `lr`,
    at most 0.5% of all elements beyond that, each within 2 lr + 1e-6."""
    beyond, total = 0, 0
    for name, a in ref.items():
        a, b = a.detach().float(), got[name].detach().float()
        d = (a - b).abs()
        tol = 1e-4 * float(a.abs().max()) + 1e-6
        total += a.numel()
        if lr is None:
            assert float(d.max()) <= tol, (name, float(d.max()), tol)
        else:
            beyond += int((d > tol).sum())
            assert float(d.max()) <= 2 * lr + 1e-6, (name, float(d.max()))
    assert beyond <= 0.005 * total, (beyond, total)


def _one_process(init, case):
    model, opt_args, kind = W.case_table(init)[case]
    opt = build_optimizer({"optimizer": {"type": "AdamW", "args": opt_args}}, model.parameters())
    if kind == "qa":
        step = make_qa_train_step(model, CrossEntropy(), opt, deterministic=True)
    else:
        step = make_retrieval_train_step(model, W.loss_obj(), opt, deterministic=True,
                                         mlm_weight=0.5 if kind == "mlm" else 0.0)
    return W.run_steps(model, step, kind, 0, W.B)


@pytest.mark.parametrize("case", CASES)
def test_dp_steps_match_one_process(dp, case):
    init, ranks = dp
    ref = _one_process(init, case)
    for got in (r[case] for r in ranks):
        for m_ref, m_got in zip(ref["metrics"], got["metrics"]):
            assert m_ref.keys() == m_got.keys()
            for k in m_ref:
                np.testing.assert_allclose(m_got[k], m_ref[k], rtol=1e-5, atol=1e-6, err_msg=k)
        assert ref["grads"].keys() == got["grads"].keys()
        close_tensors(ref["grads"], got["grads"])
        close_tensors(ref["params"], got["params"], lr=LR)
    # the ranks hold one model
    for name, p in ranks[0][case]["params"].items():
        assert torch.equal(p, ranks[1][case]["params"][name]), name


def test_mlm_count_differs_between_ranks():
    """The MLM case is only a test of the global count where the ranks'
    halves hold different numbers of masked tokens."""
    for i in (1, 2):
        labels = W.make_batch(i, mlm=True)["mlm_labels"]
        assert (labels[:4] != -100).sum() != (labels[4:] != -100).sum()


def test_eval_loss_excludes_pad_rows(dp):
    init, ranks = dp
    model = W.tiny_model()
    model.load_state_dict(init["retrieval"])
    batch = W.rows(W.make_batch(7), 0, 6)
    ref = [float(x) for x in make_retrieval_eval_step(model, W.loss_obj())(W.to_torch(batch))[1]]
    for r in ranks:
        np.testing.assert_allclose(r["eval"], ref, rtol=1e-5)


def test_serving_gathers_in_dataset_order(dp):
    init, ranks = dp
    model = W.tiny_model()
    model.load_state_dict(init["retrieval"])
    ref = W.embed_and_score(model, None, 0, 1)
    assert len(ref["meta"]["paths"]) == 9
    for r in ranks:
        got = r["serve"]
        assert got["meta"] == ref["meta"]
        for k, v in ref["cat"].items():
            np.testing.assert_allclose(got["cat"][k], v, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(v).max()), err_msg=k)
        np.testing.assert_allclose(got["sims"], ref["sims"], rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref["sims"]).max()))


def test_text_bucket_agreement(tmp_path):
    W.spawn(W.bucket_case, 2, str(tmp_path))
    assert _ranks(str(tmp_path)) == [32, 32]


def test_host_gathers_run_on_gloo_groups_of_their_own(tmp_path):
    W.spawn(W.host_group_case, 4, str(tmp_path))
    for rank, res in enumerate(_ranks(str(tmp_path), 4)):
        data = [rank % 2, rank % 2 + 2]  # mesh (2, 2): data groups {0, 2} and {1, 3}
        assert res["world_own"] and res["data_own"], res
        assert res["backends"] == ["gloo", "gloo"]
        assert res["data_ranks"] == data and res["gathered"] == data
        assert res["max"] == 3


def test_checkpoint_save_and_resume_on_both_ranks(tmp_path):
    init = _init()
    W.spawn(W.checkpoint_case, 2, str(tmp_path), init, 1)
    files = sorted(p.name for p in (tmp_path / "ckpt").iterdir())
    assert files == ["checkpoint-epoch1.pth"]  # one writer, no temporary left
    for r in _ranks(str(tmp_path)):
        assert (r["epoch"], r["count"]) == (1, 2)
        for k, v in r["saved"].items():
            assert torch.equal(r["restored"][k], v), k
        assert r["resumed"] == r["live"]
        for k, v in r["live_params"].items():
            assert torch.equal(r["resumed_params"][k], v), k


@pytest.mark.parametrize("model_axis,same", [(1, False), (2, True)],
                         ids=["data-ranks-differ", "model-ranks-agree"])
def test_dropout_masks_by_data_rank(tmp_path, model_axis, same):
    W.spawn(W.dropout_case, 2, str(tmp_path), model_axis)
    a, b = _ranks(str(tmp_path))
    assert a.shape == b.shape and 0.3 < float(a.float().mean()) < 0.7  # p = 0.5 drew
    assert torch.equal(a, b) == same
