"""`remat` (the top-level config key): the region tower's blocks recomputed
in the backward under torch.utils.checkpoint. On the CPU, configs/smoke/
synthetic_retrieval.json from the same seeded weights and batch, with and
without it: the region tower's output and every parameter's gradient are
bit-identical with dropout off (eval mode), and with dropout on (train
mode, the text tower's dropout drawn from the same torch seed) the whole
model's embeddings and gradients are too. The region tower has no dropout
of its own, so one case adds dropout to each block's output: the
recompute must draw the same masks (the RNG state kept). It changes
memory only."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from demovlp_tpu_torch.cli import common
from demovlp_tpu_torch.data.tokenizer import SimpleTokenizer
from demovlp_tpu_torch.train.steps import batch_to_device, prepare_batch, retrieval_losses

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ROOT / "configs" / "smoke" / "synthetic_retrieval.json"


def _batch(cfg):
    dl = common.init_dataloaders(cfg)[0][0]
    dl.set_epoch(1)
    return batch_to_device(prepare_batch(next(iter(dl)), SimpleTokenizer()), torch.device("cpu"))


def _with_block_dropout(blk):
    forward = blk.forward
    blk.forward = lambda *args, **kw: F.dropout(forward(*args, **kw), 0.3, blk.training)


def _run(remat: bool, train: bool, whole: bool, block_dropout: bool = False):
    cfg = json.loads(SMOKE.read_text())
    cfg["remat"] = remat
    model = common.build_train_model(cfg, torch.device("cpu"), seed=3)
    assert model.object_model.remat == remat
    if block_dropout:
        for blk in model.object_model.blocks:
            _with_block_dropout(blk)
    model.train(train)
    batch = _batch(cfg)
    torch.manual_seed(11)
    if whole:
        out = model(batch)
        loss = retrieval_losses(common.build_loss(cfg), out, batch)[0]
        outs = [out[k] for k in sorted(out)]
    else:
        emb, _ = model.object_model(batch["object"], batch["object_mask"])
        loss = (emb * torch.linspace(-1, 1, emb.numel()).reshape(emb.shape)).sum()
        outs = [emb]
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return [o.detach() for o in outs], grads


@pytest.mark.parametrize("train,whole,block_dropout", [
    (False, False, False), (False, True, False), (True, True, False), (True, False, True),
], ids=["tower-eval", "model-eval", "model-train-dropout", "tower-train-block-dropout"])
def test_remat_is_exact(train, whole, block_dropout):
    a_out, a_grads = _run(False, train, whole, block_dropout)
    b_out, b_grads = _run(True, train, whole, block_dropout)
    for a, b in zip(a_out, b_out, strict=True):
        assert torch.equal(a, b)
    assert set(a_grads) == set(b_grads) and any(n.startswith("object_model.blocks")
                                                for n in a_grads)
    for name, g in a_grads.items():
        assert torch.equal(g, b_grads[name]), name


def test_remat_is_off_without_grad():
    cfg = json.loads(SMOKE.read_text())
    cfg["remat"] = True
    model = common.build_train_model(cfg, torch.device("cpu"), seed=3).eval()
    batch = _batch(cfg)
    with torch.no_grad():
        emb, _ = model.object_model(batch["object"], batch["object_mask"])
    assert not emb.requires_grad
