"""Training traffic: the port's own train loop (`RetrievalTrainer`, built
from the cell's configuration as the train CLI builds it, with validation
and checkpoints off), fed by the port's loader (over the run's inputs,
harness/dataset.py) through TimedLoader.

Set-up: the kernels built, the model built on the meta device and given
storage on the card, the weights made there from the seed, the trainer
built; then the trainer's first `check_steps` steps (the compared ones)
through its own epoch call and loader, which also warm every shape the
window uses; during them the program's local similarity is tapped
(LocalTap) for the comparison of its local stage alone. Window: one epoch
call of the trainer, handed batches until the window's seconds have
passed; it ends once the last step's loss has been read and the card
synchronised. After it: the peak memory is read,
the program's state freed, and the reference works the compared steps
out again.
"""
from __future__ import annotations

import copy
import tempfile
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from benchmark.counts import flops as counts
from benchmark.harness import trace as tracing
from benchmark.harness.dataset import make_loader
from benchmark.harness.loader import TimedLoader
from benchmark.harness.outcome import Check, Outcome, device_info
from benchmark.harness.weights import init_params
from benchmark.reference import checks, data, model as ref_model

BIG = 1 << 40


def program_config(config: Dict[str, Any]) -> Dict[str, Any]:
    return copy.deepcopy(config["program"])


def build(ctx, cfg: Dict[str, Any], save_dir: Path):
    """(trainer, loader wrapper, the starting weights on the host)."""
    from demovlp_tpu_torch.cli import common
    from demovlp_tpu_torch.train.retrieval import RetrievalTrainer

    device = ctx.device
    with torch.device("meta"):
        net = common.build_model(cfg)
    net = net.to_empty(device=device)
    init_params(net.named_parameters(), ctx.seed)
    p0 = {n: p.detach().to("cpu", copy=True) for n, p in net.named_parameters()}
    w = ref_model.Widths.from_config(cfg)
    inputs = data.Inputs(ctx.seed, int(ctx.traffic["samples_per_epoch"]), w.frames, w.regions,
                         device)
    loader = TimedLoader(make_loader(inputs, int(cfg["data_loader"]["args"]["batch_size"]),
                                     int(ctx.traffic["loader_workers"]), ctx.seed, train=True))
    bf16 = common.compute_dtype(cfg) == torch.bfloat16
    trainer = RetrievalTrainer(
        net, common.build_loss(cfg), common.build_metrics(cfg),
        common.build_optimizer(cfg, net.parameters()), cfg, save_dir, device,
        data_loader=[loader], valid_data_loader=[], tokenizer=common.build_tokenizer_from_config(cfg),
        max_samples_per_epoch=BIG, transfer_dtype=torch.bfloat16 if bf16 else None,
        lr_mode=cfg["trainer"].get("lr_mode", "reference"), rng_seed=ctx.seed,
        writer=None, visualizer=None, mesh=None)
    return trainer, loader, p0


def leaf_norms_program(trainer, names, b1: float):
    """Per leaf (sorted names): the first step's gradient norm from the
    optimizer's first moment, m / (1 - b1)."""
    params = dict(trainer.model.named_parameters())
    out = []
    for n in names:
        mu = trainer.optimizer.state.get(params[n], {}).get("mu")
        # no first moment: the optimizer took no step
        out.append(0.0 if mu is None else
                   float(torch.linalg.vector_norm(mu.double())) / (1.0 - b1))
    return out


class LocalTap:
    """Records each call of the program's local similarity (`local_scores`
    of its losses module) while installed: its inputs, its scores and the
    gradients that the backward hands the scores and each embedding
    (checks.tap_local, checks.tap_scores)."""

    def __init__(self, module):
        self.module, self.fn = module, module.local_scores
        self.records: list = []
        module.local_scores = self

    def __call__(self, im, s, im_mask, s_mask, *args, **kwargs):
        im, s, rec = checks.tap_local(im, s, im_mask, s_mask)
        scores = self.fn(im, s, im_mask, s_mask, *args, **kwargs)
        checks.tap_scores(rec, scores)
        self.records.append(rec)
        return scores

    def close(self) -> None:
        self.module.local_scores = self.fn


def run(ctx) -> Outcome:
    from demovlp_tpu_torch.losses import losses as program_losses
    from demovlp_tpu_torch.ops import cuda_build
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    cfg = program_config(ctx.config)
    traffic = ctx.traffic
    device = ctx.device
    n_check = int(traffic["check_steps"])
    batch = int(cfg["data_loader"]["args"]["batch_size"])
    if device.type == "cuda":
        cuda_build.build(["xattn_sim_fwd", "xattn_sim_bwd"])
    tmp = tempfile.TemporaryDirectory(prefix="demovlp_bench_")
    trainer, loader, p0 = build(ctx, cfg, Path(tmp.name))
    names = sorted(p0)
    shapes = ref_model.param_shapes(ref_model.Widths.from_config(cfg))
    notes = []
    if {n: tuple(v.shape) for n, v in p0.items()} != shapes:
        notes.append("the program's parameters are not the configuration's (names or shapes)")
    b1 = float(cfg["optimizer"]["args"].get("b1", 0.9))

    # the compared steps: step 1, then the rest, through the trainer's epoch call
    tap = LocalTap(program_losses)
    try:
        loader.quota = 1
        trainer._train_epoch(1)
        prog = {"names": names, "grad_norms": leaf_norms_program(trainer, names, b1)}
        loader.quota = n_check - 1
        trainer._train_epoch(1)
    finally:
        tap.close()
    local_records = [{k: v.to("cpu") for k, v in rec.items()} for rec in tap.records]
    if len(local_records) != n_check:
        notes.append(f"the program's local similarity ran {len(local_records)} times in "
                     f"{n_check} compared steps")
    prog["p3"] = {n: p.detach().to("cpu", copy=True) for n, p in trainer.model.named_parameters()}
    prog["losses"] = list(trainer.step_losses[:n_check])
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    # the window
    seconds = min(ctx.seconds, float(traffic["trace_seconds"])) if ctx.trace else ctx.seconds
    xk.reset_launch_counts()
    first = len(trainer.step_losses)
    waits_before = len(loader.waits)
    loader.quota = None
    spans = tracing.HostSpans()
    if ctx.trace:
        spans.wrap(trainer, "train_arrays", "prepare")
        spans.wrap(trainer, "_train_step", "step_call")
    cm = tracing.maybe_traced(ctx.trace, ctx.out_dir)
    setup_s = time.time() - ctx.t_start
    with cm as holder:
        t0 = tracing.edge(device)
        loader.deadline = t0 + seconds
        trainer._train_epoch(1)
        window_s = tracing.edge(device) - t0
    spans.unwrap()
    if holder.get("trace") is not None:
        for a, b in loader.waits[waits_before:]:
            spans.add("next_batch", a, b)
        spans.place(holder["trace"], t0)
    steps = len(trainer.step_losses) - first
    window_losses = trainer.step_losses[first:]
    launches = dict(xk.SHAPE_LAUNCHES)
    waits = [b - a for a, b in loader.waits[waits_before:]]
    info = device_info(device, ctx.chips)
    loader.close()
    del trainer
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, over the compared steps' inputs worked out again
    w = ref_model.Widths.from_config(cfg)
    n = int(traffic["samples_per_epoch"])
    inputs = data.Inputs(ctx.seed, n, w.frames, w.regions, device)
    order = data.train_order(ctx.seed, 1, n)
    batches = [inputs.batch(order[i * batch:(i + 1) * batch]) for i in range(n_check)]
    t_ref = time.perf_counter()
    ref = checks.reference_train(cfg, ctx.seed, batches, p0, device)
    detail: Dict[str, Any] = {}
    numbers = checks.compare_train(prog, ref, p0, detail)
    numbers.update(checks.compare_local(local_records, checks.loss_args(cfg), device))
    limits = traffic["limits"]
    failed = sum(not np.isfinite(x) for x in window_losses)
    samples = steps * batch
    window = {
        "kind": "train", "units": samples, "steps": steps, "window_s": window_s,
        "data_waits_s": waits, "xattn_launches": launches,
        "xattn_items": lambda ls, lq: (batch, batch), "d": w.proj,
        "local_precision": cfg["loss"]["args"].get("local_dtype", "float32"),
        "flops_per_step": counts.retrieval_step(batch, w.frames, w.regions, data.TEXT_LEN,
                                                w.proj, w.obj_depth, w.obj_dim, w.text_layers,
                                                w.text_dim),
        "device_name": info["kind"], "trace": holder.get("trace"),
        "reference_s": time.perf_counter() - t_ref, "check_detail": detail,
    }
    tmp.cleanup()
    return Outcome(setup_s=setup_s,
                   end_to_end={"train_samples_per_s": samples / window_s, "setup_s": setup_s},
                   attempted=steps, failed=failed,
                   checks=[Check(k, float(v), float(limits[k])) for k, v in numbers.items()],
                   device=info, window=window, notes=notes)

