"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, planted in the program, on the CPU at a tiny
size with every product in float32 (the harness's look for a card
skipped), against the committed limits; the same runs unbroken come out
correct. The cells have no exchange between cards to leave out."""
from __future__ import annotations

import pytest
import torch

from benchmark.tests.tiny import make_root, run_cell


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("faults"), "float32")


@pytest.mark.parametrize("cell", ["pt", "ft"])
def test_sound_training_run_is_correct(root, cell):
    rc, result, err = run_cell(root, cell)
    assert rc == 0 and result["correct"] is True, err[-2000:]


@pytest.mark.parametrize("cell", ["pt", "ft"])
def test_state_left_unchanged(root, cell, monkeypatch):
    from demovlp_tpu_torch.train.optim import AdamW

    monkeypatch.setattr(AdamW, "step", lambda self, closure=None: None)
    rc, result, _ = run_cell(root, cell)
    assert rc == 0 and result["correct"] is False
    assert result["checks"]["update_gap"]["value"] > result["checks"]["update_gap"]["limit"]


@pytest.mark.parametrize("cell", ["pt", "ft"])
def test_half_batch_mean_over_the_rest(root, cell, monkeypatch):
    from demovlp_tpu_torch.train import steps

    plain = steps.retrieval_losses

    def half(loss_obj, outputs, batch, valid=None):
        n = batch["attention_mask"].shape[0] // 2
        outputs = {k: v[:n] for k, v in outputs.items()}
        batch = {k: v[:n] for k, v in batch.items()}
        return plain(loss_obj, outputs, batch, valid)

    monkeypatch.setattr(steps, "retrieval_losses", half)
    rc, result, _ = run_cell(root, cell)
    assert rc == 0 and result["correct"] is False


def test_sound_query_run_is_correct(root):
    rc, result, err = run_cell(root, "query")
    assert rc == 0 and result["correct"] is True, err[-2000:]


def test_answer_altered(root, monkeypatch):
    from demovlp_tpu_torch import serve

    plain = serve.topk_retrieval

    def altered(sims, k=10, **kw):
        out = plain(sims, k=k, **kw)
        for r in out:
            worst = int(sims[r["query_index"]].argmin())
            r["topk_indices"][0] = worst
            r["topk_scores"][0] = float(sims[r["query_index"], worst])
        return out

    monkeypatch.setattr(serve, "topk_retrieval", altered)
    rc, result, _ = run_cell(root, "query")
    assert rc == 0 and result["correct"] is False


def test_query_scores_altered(root, monkeypatch):
    """Scores shifted where they are produced, the ranking kept."""
    from demovlp_tpu_torch import serve

    plain = serve.query_sims
    monkeypatch.setattr(serve, "query_sims", lambda *a, **kw: plain(*a, **kw) + 0.5)
    rc, result, _ = run_cell(root, "query")
    assert rc == 0 and result["correct"] is False


def test_no_tf32_leaks_into_the_reference(root):
    run_cell(root, "pt")
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.parametrize("cell,below", [("pt", "fp8"), ("ft", "tf32"), ("query", "tf32")])
def test_local_stage_below_its_precision(root, cell, below, monkeypatch):
    """The local similarity fed embeddings rounded one step below the
    configuration's local precision (float8 below pre-training's bfloat16,
    TF32 below float32), the towers untouched."""
    from benchmark.reference import precision

    low = getattr(precision, below)

    if cell == "query":
        from demovlp_tpu_torch import serve

        plain = serve.sharded_local_sims

        def rounded(img, lang, *args, **kwargs):
            return plain(low(torch.as_tensor(img)).numpy(), low(torch.as_tensor(lang)).numpy(),
                         *args, **kwargs)

        monkeypatch.setattr(serve, "sharded_local_sims", rounded)
    else:
        from demovlp_tpu_torch.losses import losses

        plain = losses.local_scores
        monkeypatch.setattr(losses, "local_scores",
                            lambda im, s, *args: plain(im + (low(im) - im).detach(),
                                                       s + (low(s) - s).detach(), *args))
    rc, result, _ = run_cell(root, cell)
    assert rc == 0 and result["correct"] is False
    local = "local_gap" if cell == "query" else "local_score_gap"
    assert result["checks"][local]["value"] > result["checks"][local]["limit"]
