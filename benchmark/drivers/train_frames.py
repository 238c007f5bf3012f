"""Training traffic on raw frames (Frozen in Time): the port's own train
loop (`RetrievalTrainer`, built from the cell's configuration as the train
CLI builds it, with validation and checkpoints off), fed by the port's
loader over the run's seeded clips (reference/frames.py, through
harness/frames_dataset.py) through TimedLoader, as drivers/train.py runs
a region cell.

Set-up: the model built on the meta device and given storage on the
card, the weights made there from the seed, the trainer built; then the
trainer's first `check_steps` steps (the compared ones) through its own
epoch call and loader, which also warm every shape the window uses.
Window: one epoch call of the trainer, handed batches until the window's
seconds have passed; it ends once the last step's loss has been read and
the card synchronised. A traced window also keeps each kernel's launch
(harness/launches.py) for `video_attn_share.train`. After it: the peak
memory is read, the program's state freed, and the reference works the
compared steps out again (reference/frozen_steps.py), a chunk of
`reference_chunk` videos at a time.
"""
from __future__ import annotations

import tempfile
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from benchmark.counts import frozen_flops
from benchmark.drivers.train import BIG, leaf_norms_program, program_config
from benchmark.harness import launches as tracing_launches
from benchmark.harness import trace as tracing
from benchmark.harness.frames_dataset import make_loader
from benchmark.harness.loader import TimedLoader
from benchmark.harness.outcome import Check, Outcome, device_info
from benchmark.harness.weights import init_params
from benchmark.reference import checks, data, frozen, frozen_steps
from benchmark.reference.frames import FrameInputs


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
    w = frozen.Widths.from_config(cfg)
    inputs = FrameInputs(ctx.seed, int(ctx.traffic["samples_per_epoch"]), w.frames,
                         w.resolution, int(ctx.traffic["pool"]), device)
    loader = TimedLoader(make_loader(inputs, int(cfg["data_loader"]["args"]["batch_size"]),
                                     int(ctx.traffic["loader_workers"]), ctx.seed))
    bf16 = common.compute_dtype(cfg) == torch.bfloat16
    trainer = RetrievalTrainer(
        net, common.build_loss(cfg), common.build_metrics(cfg),
        common.build_optimizer(cfg, net.parameters()), cfg, save_dir, device,
        data_loader=[loader], valid_data_loader=[], tokenizer=common.build_tokenizer_from_config(cfg),
        max_samples_per_epoch=BIG, transfer_dtype=torch.bfloat16 if bf16 else None,
        lr_mode=cfg["trainer"].get("lr_mode", "reference"), rng_seed=ctx.seed,
        writer=None, visualizer=None, mesh=None)
    return trainer, loader, p0, inputs


def run(ctx) -> Outcome:
    cfg = program_config(ctx.config)
    traffic = ctx.traffic
    device = ctx.device
    n_check = int(traffic["check_steps"])
    batch = int(cfg["data_loader"]["args"]["batch_size"])
    tmp = tempfile.TemporaryDirectory(prefix="demovlp_bench_")
    trainer, loader, p0, inputs = build(ctx, cfg, Path(tmp.name))
    names = sorted(p0)
    w = frozen.Widths.from_config(cfg)
    notes = []
    if {n: tuple(v.shape) for n, v in p0.items()} != frozen.param_shapes(w):
        notes.append("the program's parameters are not the configuration's (names or shapes)")
    b1 = float(cfg["optimizer"]["args"].get("b1", 0.9))

    # the compared steps: step 1, then the rest, through the trainer's epoch call
    loader.quota = 1
    trainer._train_epoch(1)
    prog = {"names": names, "grad_norms": leaf_norms_program(trainer, names, b1)}
    loader.quota = n_check - 1
    trainer._train_epoch(1)
    prog["p3"] = {n: p.detach().to("cpu", copy=True) for n, p in trainer.model.named_parameters()}
    prog["losses"] = list(trainer.step_losses[:n_check])
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    # the window
    seconds = min(ctx.seconds, float(traffic["trace_seconds"])) if ctx.trace else ctx.seconds
    first = len(trainer.step_losses)
    waits_before = len(loader.waits)
    loader.quota = None
    spans = tracing.HostSpans()
    if ctx.trace:
        spans.wrap(trainer, "train_arrays", "prepare")
        spans.wrap(trainer, "_train_step", "step_call")
    cm = tracing_launches.maybe_traced(ctx.trace, ctx.out_dir)
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
    waits = [b - a for a, b in loader.waits[waits_before:]]
    info = device_info(device, ctx.chips)
    loader.close()
    del trainer
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, over the compared steps' inputs
    order = data.train_order(ctx.seed, 1, inputs.n)
    batches = [inputs.batch(order[i * batch:(i + 1) * batch]) for i in range(n_check)]
    t_ref = time.perf_counter()
    ref = frozen_steps.reference_train(cfg, ctx.seed, batches, p0, device,
                                       chunk=int(traffic["reference_chunk"]))
    detail: Dict[str, Any] = {}
    numbers = checks.compare_train(prog, ref, p0, detail)
    limits = traffic["limits"]
    failed = sum(not np.isfinite(x) for x in window_losses)
    samples = steps * batch
    window = {
        "kind": "train", "units": samples, "steps": steps, "window_s": window_s,
        "data_waits_s": waits,
        "flops_per_step": frozen_flops.step(batch, w.frames, w.patches, data.TEXT_LEN, w.patch,
                                            w.dim, w.depth, w.text_dim, w.text_layers, w.proj),
        "device_name": info["kind"], "trace": holder.get("trace"),
        "launches": holder.get("launches"),
        "reference_s": time.perf_counter() - t_ref, "check_detail": detail,
    }
    tmp.cleanup()
    return Outcome(setup_s=setup_s,
                   end_to_end={"train_samples_per_s": samples / window_s, "setup_s": setup_s},
                   attempted=steps, failed=failed,
                   checks=[Check(k, float(v), float(limits[k])) for k, v in numbers.items()],
                   device=info, window=window, notes=notes)
