"""Frozen in Time on the port's training path, on the CPU at a tiny size
(2 blocks of width 64, 4 heads, 3 frames of 48 x 48: 9 patches a frame,
28 video tokens):

  * `FrozenInTime` against the plain reference (reference_torch/
    frozen_in_time.py) from the same weights and inputs, both in float32:
    the two global embeddings, the NormSoftmax loss and every parameter's
    gradient, each to a tolerance that a bf16 tower misses;
  * the grouped divided attention (`attn_impl` "xla", and "dense" beside
    it) against the reference's per-group softmax attention at the
    1 + F N layout, time and space, CLS row included;
  * the shipped config builds the published widths through
    `cli/common.build_model` / `build_loss`;
  * the train CLI trains the config, narrowed, through `RetrievalTrainer`
    and the port's loader on uint8 pixel batches, with validation;
  * the pixel dataset's seeded pool, the uint8 collate and upload;
  * the spans `video.patch_embed`, `video.time_attn`, `video.space_attn`
    (forward and backward) and the counters `video.tokens` and
    `train.upload_bytes` under a profiler session, and none without one;
  * the region path: its parameter names and outputs as before the blocks
    were shared (pinned), and unchanged by the spans' option.
"""
from __future__ import annotations

import hashlib
import json
import statistics
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from demovlp_tpu_torch.cli import common
from demovlp_tpu_torch.cli import train as train_cli
from demovlp_tpu_torch.data.datasets import dataset_object_loader
from demovlp_tpu_torch.data.loader import MultiDistTextObjectVideoDataLoader
from demovlp_tpu_torch.losses.losses import NormSoftmaxLoss
from demovlp_tpu_torch.models import DistilBertConfig, FrozenInTime, ObjectRelation
from demovlp_tpu_torch.models.object_transformer import VarAttention
from demovlp_tpu_torch.train.steps import (batch_to_device, make_retrieval_train_step,
                                           prepare_batch, retrieval_losses)
from demovlp_tpu_torch.utils import profiling
from reference_torch import frozen_in_time as ref

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "demovlp_tpu_torch" / "configs" / "ft" / "msrvtt_frozen_4f.json"
TEXT = DistilBertConfig(vocab_size=1000, dim=64, n_layers=2, n_heads=4, hidden_dim=128,
                        max_position_embeddings=32)
WIDTHS = ref.Widths(vocab=1000, text_dim=64, text_layers=2, text_heads=4, text_hidden=128,
                    max_positions=32, frames=3, resolution=48, patch=16, dim=64, depth=2,
                    heads=4, proj=32)
B, L = 6, 12
# float32 on both sides differs by summation order alone: embeddings and
# loss to 1e-5 (measured 4e-6 on the embeddings), each gradient's gap to
# 1e-4 of max(its norm, the median leaf's) (measured 4e-6). A bf16 tower
# misses both by orders of magnitude (0.03 on the gradients).
EMBED_TOL, LOSS_TOL, GRAD_TOL = 1e-5, 1e-5, 1e-4


def _model(dtype=torch.float32):
    m = FrozenInTime(num_frames=3, resolution=48, patch_size=16, embed_dim=64, depth=2,
                     num_heads=4, projection_dim=32, text_config=TEXT, compute_dtype=dtype)
    m.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():  # no entry left at its init constant
        g = torch.Generator().manual_seed(2)
        for n, p in m.named_parameters():
            if "temporal" in n or n.endswith("bias"):
                p.copy_(0.02 * torch.randn(p.shape, generator=g))
    return m.eval()


def _batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    mask = torch.ones(B, L, dtype=torch.long)
    mask[:, 8:] = 0
    return {"input_ids": torch.randint(1000, (B, L), generator=g), "attention_mask": mask,
            "video": torch.randint(0, 256, (B, 3, 3, 48, 48), generator=g, dtype=torch.uint8)}


def _port(m, batch):
    out = m(batch)
    loss = retrieval_losses(NormSoftmaxLoss(0.05), out, batch)[0]
    names = [n for n, _ in m.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in m.named_parameters()])
    return out, loss.detach(), dict(zip(names, grads))


def _gaps(m, batch):
    """(embedding gap, loss gap, worst gradient gap) of the port against
    the reference from the port's own weights."""
    out, loss, grads = _port(m, batch)
    P = {n: p.detach().float().clone().requires_grad_(True) for n, p in m.named_parameters()}
    t, v = (e.detach() for e in ref.forward(P, WIDTHS, batch)[:2])
    r_loss, r_grads = ref.loss_and_grads(P, WIDTHS, batch)
    g_t, g_v = (out[k].detach().float() for k in ("global_text_embeddings",
                                                   "global_object_embeddings"))
    emb = max(float((g_t - t).abs().max() / t.abs().max()),
              float((g_v - v).abs().max() / v.abs().max()))
    med = statistics.median(float(g.norm()) for g in r_grads.values())
    grad = max(float((grads[n].float() - r_grads[n]).norm()) / max(float(r_grads[n].norm()), med)
               for n in r_grads)
    return emb, abs(float(loss) - float(r_loss)) / abs(float(r_loss)), grad


def test_parameters_are_the_references():
    m = _model()
    assert {n: tuple(p.shape) for n, p in m.named_parameters()} == ref.param_shapes(WIDTHS)


def test_port_matches_reference_in_float32():
    emb, loss, grad = _gaps(_model(), _batch())
    assert emb < EMBED_TOL and loss < LOSS_TOL and grad < GRAD_TOL, (emb, loss, grad)


def test_bf16_tower_misses_the_tolerances():
    emb, loss, grad = _gaps(_model(torch.bfloat16), _batch())
    assert emb > 10 * EMBED_TOL and grad > 10 * GRAD_TOL, (emb, loss, grad)


def test_chunked_reference_gradient_is_the_whole():
    batch = _batch(3)
    P = {n: p.detach().clone().requires_grad_(True) for n, p in _model().named_parameters()}
    loss, whole = ref.loss_and_grads(P, WIDTHS, batch)
    loss_c, chunked = ref.loss_and_grads(P, WIDTHS, batch, chunk=4)
    assert abs(float(loss) - float(loss_c)) < 1e-6
    med = statistics.median(float(g.norm()) for g in whole.values())
    assert max(float((chunked[n] - whole[n]).norm()) / max(float(whole[n].norm()), med)
               for n in whole) < 1e-5


@pytest.mark.parametrize("impl", ["xla", "dense"])
@pytest.mark.parametrize("mode", ["time", "space"])
def test_divided_attention_matches_per_group_reference(mode, impl):
    torch.manual_seed(7)
    f, n, d, h = 3, 9, 64, 4
    att = VarAttention(d, h, impl)
    x = torch.randn(2, 1 + f * n, d, requires_grad=True)
    y = att(x, torch.zeros(2, 1 + f * n), mode, f, n)
    P = {"a.qkv.weight": att.qkv.weight, "a.qkv.bias": att.qkv.bias,
         "a.proj.weight": att.proj.weight, "a.proj.bias": att.proj.bias}
    w = ref.Widths(dim=d, heads=h, resolution=48, patch=16, frames=f)
    want = ref._var_attention(x, P, "a", w, mode, f, lambda t: t)
    assert torch.allclose(y, want, atol=2e-6, rtol=1e-5)
    assert torch.allclose(y[:, 0], want[:, 0], atol=2e-6, rtol=1e-5)  # the CLS row
    gx, = torch.autograd.grad(y.square().sum(), x)
    gw, = torch.autograd.grad(want.square().sum(), x)
    assert torch.allclose(gx, gw, atol=1e-5, rtol=1e-4)


def test_config_builds_the_published_widths():
    cfg = json.loads(CONFIG.read_text())
    with torch.device("meta"):
        m = common.build_model(cfg)
    assert isinstance(m, FrozenInTime) and isinstance(common.build_loss(cfg), NormSoftmaxLoss)
    vm = m.video_model
    assert (len(vm.blocks), vm.patches_per_frame, vm.num_frames) == (12, 196, 4)
    assert tuple(vm.pos_embed.shape) == (1, 197, 768)
    assert vm.blocks[0].has_time and vm.blocks[0].attn.attn_impl == "xla"
    assert vm.blocks[0].attn.num_heads == 12 and vm.blocks[0].mlp.fc1.out_features == 3072
    assert tuple(m.vid_proj[0].weight.shape) == (256, 768)
    assert m.text_model.config.n_layers == 6 and common.compute_dtype(cfg) == torch.bfloat16
    assert common.build_loss(cfg).temperature == 0.05
    cfg["arch"]["args"]["video_params"]["attn_impl"] = "dense"
    with pytest.raises(ValueError, match="grouped form"):
        common.build_model(cfg)


def _narrowed(tmp_path):
    cfg = json.loads(CONFIG.read_text())
    args = cfg["arch"]["args"]
    args["video_params"].update(resolution=48, embed_dim=64, depth=2, heads=4, num_frames=3)
    args["text_params"].update(model="", config=dict(
        vocab_size=30522, dim=64, n_layers=2, n_heads=4, hidden_dim=128,
        max_position_embeddings=128))
    args["projection_dim"] = 32
    cfg["precision"]["compute"] = "float32"
    loader = cfg["data_loader"]["args"]
    loader.update(batch_size=4, num_workers=2)
    loader["video_params"].update(num_frames=3, input_res=48, num_samples=16, eval_samples=8,
                                  pool=8)
    cfg["trainer"].update(save_dir=str(tmp_path), epochs=1, init_val=False)
    return cfg


def test_train_cli_trains_pixel_batches(tmp_path):
    cfg = _narrowed(tmp_path)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    trainer = train_cli.run(["-c", str(path), "--device", "cpu"])
    assert isinstance(trainer.model, FrozenInTime)
    assert len(trainer.step_losses) == 4 and all(np.isfinite(trainer.step_losses))
    assert trainer.data_loader[0].dataset.pool.dtype == np.uint8
    assert 0.0 <= float(trainer.final_log["val_0_t2v_metrics_R1"]) <= 100.0
    assert np.isfinite(trainer.final_log["val_loss_0"])


def test_pixel_loader_batches_uint8():
    vp = {"num_frames": 3, "input_res": 48, "num_samples": 12, "pool": 5}
    dl = MultiDistTextObjectVideoDataLoader("SyntheticPixels", {}, video_params=vp,
                                            batch_size=4, num_workers=2, seed=1,
                                            process_index=0, process_count=1)
    batch = next(iter(dl))
    assert batch["video"].dtype == np.uint8 and batch["video"].shape == (4, 3, 3, 48, 48)
    assert "object" not in batch and len(batch["text"]) == 4
    again = dataset_object_loader("SyntheticPixels", video_params=vp, text_params={})
    assert np.array_equal(again.get_item(7)["video"], dl.dataset.get_item(2)["video"])  # 7 % 5
    assert again.get_item(3)["text"] == dl.dataset.get_item(3)["text"]
    arrays = prepare_batch(batch, common.build_tokenizer(""))
    assert set(arrays) == {"input_ids", "attention_mask", "video"}
    on = batch_to_device(arrays, torch.device("cpu"), torch.bfloat16)
    assert on["video"].dtype == torch.uint8  # the cast applies to regions only


def test_spans_and_counters_under_a_session():
    m = _model()
    opt = common.build_optimizer({"optimizer": {"type": "AdamW", "args": {"lr": 1e-4}}},
                                 m.parameters())
    step = make_retrieval_train_step(m, NormSoftmaxLoss(), opt, deterministic=True)
    arrays = {k: v.numpy() for k, v in _batch().items()}
    profiling.clear()
    step(batch_to_device(arrays, torch.device("cpu")), 1e-4)
    assert not profiling.recorded()["spans"]  # nothing without a session
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.clear()
        step(batch_to_device(arrays, torch.device("cpu")), 1e-4)
        rec = profiling.recorded()
    spans = rec["spans"]
    names = [s.name for s in spans]
    assert names.count("video.patch_embed") == 1
    # each of the 2 blocks: forward and backward of both attentions
    assert names.count("video.time_attn") == 4 and names.count("video.space_attn") == 4
    assert all(s.end_ns is not None for s in spans)
    by_index = {i: s for i, s in enumerate(spans)}
    backward = [s for s in spans if s.name == "video.space_attn"
                and s.parent >= 0 and by_index[s.parent].name == "train.backward"]
    assert len(backward) == 2
    assert rec["counters"]["video.tokens"] == B * (1 + 3 * 9)
    assert rec["counters"]["train.upload_bytes"] == B * 3 * 3 * 48 * 48 + 2 * B * L * 8


# the region path as it stood before the blocks took the span option:
# sha256 (first 16 hex) of "name:shape," over the parameters, and the sums
# of the outputs, float32 on the CPU
REGION_PIN = {
    ("dense", ""): ("81a6fb3b820567d3", -12.917755148374, -226.777401993517),
    ("dense", "timeattn"): ("43a16a6b4299e071", -16.145635001361, -96.252185895573),
    ("xla", ""): ("81a6fb3b820567d3", -12.917757516727, -226.777411517454),
    ("xla", "timeattn"): ("43a16a6b4299e071", -16.145629905164, -96.252175239148),
}


@pytest.mark.parametrize("impl,time_module", sorted(REGION_PIN))
def test_region_path_as_before(impl, time_module):
    """Names exact; the sums to 1e-6 relative (the summation order of
    another CPU's BLAS moves them by far less); outputs bit-identical with
    and without a profiler session."""
    tc = DistilBertConfig(vocab_size=1000, dim=32, n_layers=2, n_heads=4, hidden_dim=64,
                          max_position_embeddings=32)
    m = ObjectRelation(object_num=5, num_frames=3, time_module=time_module, projection_dim=16,
                       text_config=tc, object_embed_dim=32, object_depth=2, object_heads=4,
                       attn_impl=impl)
    m.reset_parameters(torch.Generator().manual_seed(3))
    m.eval()
    g = torch.Generator().manual_seed(5)
    b = {"input_ids": torch.randint(1000, (4, 10), generator=g),
         "attention_mask": torch.ones(4, 10, dtype=torch.long),
         "object": torch.randn(4, 3, 5, 2054, generator=g),
         "object_mask": (torch.rand(4, 3, 5, generator=g) > 0.3).float()}
    with torch.no_grad():
        out = m(b)
        with profile(activities=[ProfilerActivity.CPU]):
            traced = m(b)
    names = ",".join(f"{n}:{tuple(p.shape)}" for n, p in m.named_parameters())
    digest, g_sum, l_sum = REGION_PIN[(impl, time_module)]
    assert hashlib.sha256(names.encode()).hexdigest()[:16] == digest
    assert float(out["global_object_embeddings"].double().sum()) == pytest.approx(g_sum, rel=1e-6)
    assert float(out["local_object_embeddings"].double().sum()) == pytest.approx(l_sum, rel=1e-6)
    assert all(torch.equal(out[k], traced[k]) for k in out)


def test_benchmark_reference_is_a_copy():
    """The benchmark's reference of the pixel cell is this reference, byte
    for byte (the benchmark imports nothing outside its folder)."""
    ours = (ROOT / "reference_torch" / "frozen_in_time.py").read_bytes()
    assert (ROOT / "benchmark" / "reference" / "frozen.py").read_bytes() == ours
