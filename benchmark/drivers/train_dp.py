"""Data-parallel training traffic on several cards: the port's own train
loop (`RetrievalTrainer` with the (data, model) mesh of parallel/mesh.py,
as the train CLI builds it under torchrun) on `ranks` processes, one a
card, over NCCL: each rank reads its shard of the global batch through the
port's loader, the losses run over the gathered batch and the gradients
are summed over the ranks.

Launch: rank 0 is this process; the driver starts ranks 1.. itself, as
children running this file (`--job <file> --rank <r>`), since one run of
the benchmark is one process. Every run takes a fresh port from the OS (a
socket bound to port 0) for the process group's rendezvous, so no two
runs share one. A watchdog thread ends the run (exit code 1, no result)
when a child exits with an error, printing that rank's exit code and the
end of its standard error, or when the traffic's `deadline_s` has passed
since the start, killing every rank still running (the stragglers).

Set-up, on every rank: the kernels built once (by rank 0, before the
children start), the model built on the meta device and given storage on
the rank's card, the weights made there from the seed (the same on every
rank), the trainer built; then the first `check_steps` steps. Window:
every rank runs the trainer's epoch call until the window's seconds have
passed, the ranks agreeing before each batch (a max over a gloo group)
that none has passed its deadline, so all run the same steps; rank 0's
window is the one measured (and traced). After it rank 0 frees its state,
waits for the children, and the reference works out the compared steps
over the global batch (reference/dp.py), the local stage in blocks of
`local_block` rows. `train_samples_per_s` counts the global batch.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.counts import flops as counts  # noqa: E402
from benchmark.drivers.train import BIG, LocalTap, leaf_norms_program, program_config  # noqa: E402
from benchmark.harness import trace as tracing  # noqa: E402
from benchmark.harness.dataset import BenchDataset  # noqa: E402
from benchmark.harness.loader import TimedLoader  # noqa: E402
from benchmark.harness.outcome import Check, Outcome, device_info  # noqa: E402
from benchmark.harness.weights import init_params  # noqa: E402
from benchmark.reference import checks, data, dp  # noqa: E402
from benchmark.reference import model as ref_model  # noqa: E402

STDERR_TAIL = 4000  # characters of a failed rank's standard error printed


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class AgreedLoader(TimedLoader):
    """TimedLoader whose ranks agree before each batch whether any has
    passed its deadline (a max over `group`, a gloo group), so that every
    rank stops after the same step."""

    group = None

    def __iter__(self):
        import torch.distributed as dist

        if self._it is None:
            self._it = iter(self.loader)
        n = 0
        while True:
            if self.quota is not None and n >= self.quota:
                return
            if self.deadline is not None:
                late = torch.tensor([int(time.perf_counter() >= self.deadline)])
                dist.all_reduce(late, op=dist.ReduceOp.MAX, group=self.group)
                if int(late):
                    return
            t0 = time.perf_counter()
            try:
                batch = next(self._it)
            except StopIteration:
                raise RuntimeError("the train loader's epoch ended before the window; "
                                   "the traffic's samples_per_epoch is too small") from None
            self.waits.append((t0, time.perf_counter()))
            n += 1
            yield batch


def _join(job: Dict[str, Any], rank: int):
    """Join the job's process group as `rank`; (device, mesh)."""
    from demovlp_tpu_torch.parallel import mesh as pmesh

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(job["ranks"]), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(job["port"]))
    pmesh.setup_distributed(job["backend"])
    device = torch.device("cuda", rank) if job["backend"] == "nccl" else torch.device("cpu")
    return device, pmesh.create_mesh(1, device.type)


def _build(job: Dict[str, Any], rank: int, device, mesh, save_dir: Path):
    from demovlp_tpu_torch.cli import common
    from demovlp_tpu_torch.data.loader import RegionDataLoader
    from demovlp_tpu_torch.parallel.mesh import host_group
    from demovlp_tpu_torch.train.retrieval import RetrievalTrainer

    cfg, seed = job["config"], job["seed"]
    with torch.device("meta"):
        net = common.build_model(cfg)
    net = net.to_empty(device=device)
    init_params(net.named_parameters(), seed)
    p0 = {n: p.detach().to("cpu", copy=True) for n, p in net.named_parameters()}
    w = ref_model.Widths.from_config(cfg)
    inputs = data.Inputs(seed, int(job["traffic"]["samples_per_epoch"]), w.frames, w.regions,
                         device)
    loader = AgreedLoader(RegionDataLoader(
        BenchDataset(inputs), batch_size=int(cfg["data_loader"]["args"]["batch_size"]),
        shuffle=True, num_workers=int(job["traffic"]["loader_workers"]), drop_last=True,
        seed=seed, process_index=rank, process_count=int(job["ranks"])))
    loader.group = host_group()
    bf16 = common.compute_dtype(cfg) == torch.bfloat16
    trainer = RetrievalTrainer(
        net, common.build_loss(cfg), common.build_metrics(cfg),
        common.build_optimizer(cfg, net.parameters()), cfg, save_dir, device,
        data_loader=[loader], valid_data_loader=[],
        tokenizer=common.build_tokenizer_from_config(cfg), max_samples_per_epoch=BIG,
        transfer_dtype=torch.bfloat16 if bf16 else None,
        lr_mode=cfg["trainer"].get("lr_mode", "reference"), rng_seed=seed,
        writer=None, visualizer=None, mesh=mesh)
    return trainer, loader, p0


def rank_run(job: Dict[str, Any], rank: int, out_dir: Path,
             trace: bool = False) -> Optional[Dict[str, Any]]:
    """One rank's set-up, compared steps and window. Rank 0 returns what
    the comparison and the readers need (its process group closed); the
    others return None."""
    import torch.distributed as dist

    from demovlp_tpu_torch.losses import losses as program_losses
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    device, mesh = _join(job, rank)
    n_check = int(job["traffic"]["check_steps"])
    tmp = tempfile.TemporaryDirectory(prefix="demovlp_bench_")
    trainer, loader, p0 = _build(job, rank, device, mesh, Path(tmp.name))
    names = sorted(p0)
    b1 = float(job["config"]["optimizer"]["args"].get("b1", 0.9))
    tap = LocalTap(program_losses) if rank == 0 else None
    try:
        loader.quota = 1
        trainer._train_epoch(1)
        prog = {"names": names, "grad_norms": leaf_norms_program(trainer, names, b1)}
        loader.quota = n_check - 1
        trainer._train_epoch(1)
    finally:
        if tap is not None:
            tap.close()
    prog["p3"] = {n: p.detach().to("cpu", copy=True) for n, p in trainer.model.named_parameters()}
    prog["losses"] = list(trainer.step_losses[:n_check])
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    seconds = (min(job["seconds"], float(job["traffic"]["trace_seconds"])) if trace
               else job["seconds"])
    xk.reset_launch_counts()
    first = len(trainer.step_losses)
    waits_before = len(loader.waits)
    loader.quota = None
    spans = tracing.HostSpans()
    if trace:
        spans.wrap(trainer, "train_arrays", "prepare")
        spans.wrap(trainer, "_train_step", "step_call")
    dist.barrier(group=loader.group)
    cm = tracing.maybe_traced(trace, out_dir)
    setup_s = time.time() - job["t_start"]
    with cm as holder:
        t0 = tracing.edge(device)
        loader.deadline = t0 + seconds
        trainer._train_epoch(1)
        window_s = tracing.edge(device) - t0
    spans.unwrap()
    dist.barrier(group=loader.group)
    steps = len(trainer.step_losses) - first
    out = None
    if rank == 0:
        if holder.get("trace") is not None:
            for a, b in loader.waits[waits_before:]:
                spans.add("next_batch", a, b)
            spans.place(holder["trace"], t0)
        out = {"prog": prog, "p0": p0, "records": [{k: v.to("cpu") for k, v in rec.items()}
                                                   for rec in tap.records],
               "setup_s": setup_s, "window_s": window_s, "steps": steps,
               "window_losses": trainer.step_losses[first:], "trace": holder.get("trace"),
               "waits": [b - a for a, b in loader.waits[waits_before:]],
               "launches": dict(xk.SHAPE_LAUNCHES), "info": device_info(device, job["ranks"])}
    loader.close()
    del trainer
    dist.destroy_process_group()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    tmp.cleanup()
    return out


class Ranks:
    """The child ranks and the watchdog that ends the run when one fails
    or the deadline passes."""

    def __init__(self, job: Dict[str, Any], job_file: Path, out_dir: Path):
        self.procs: Dict[int, subprocess.Popen] = {}
        self.logs: Dict[int, Path] = {}
        self.deadline = time.time() + float(job["traffic"]["deadline_s"])
        import demovlp_tpu_torch

        # the children import the benchmark and the program from where this process does
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(job["root"]), str(Path(demovlp_tpu_torch.__file__).resolve().parents[1])]
            + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        for r in range(1, int(job["ranks"])):
            self.logs[r] = out_dir / f"rank{r}.err"
            with open(out_dir / f"rank{r}.out", "w") as o, open(self.logs[r], "w") as e:
                self.procs[r] = subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), "--job", str(job_file),
                     "--rank", str(r)], stdout=o, stderr=e, cwd=str(job["root"]), env=env)
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def report(self, rank: int, code) -> None:
        tail = self.logs[rank].read_text(errors="replace")[-STDERR_TAIL:]
        print(f"[train_dp] rank {rank} exited with code {code}; the end of its stderr:\n{tail}",
              file=sys.stderr, flush=True)

    def kill(self) -> None:
        for r, p in self.procs.items():
            if p.poll() is None:
                print(f"[train_dp] rank {r} still running: killed", file=sys.stderr, flush=True)
                p.kill()

    def _watch(self) -> None:
        while not self._done.wait(0.5):
            failed = [(r, p.returncode) for r, p in self.procs.items()
                      if p.poll() is not None and p.returncode != 0]
            late = time.time() > self.deadline
            if failed or late:
                for r, code in failed:
                    self.report(r, code)
                if late:
                    print("[train_dp] the run passed its deadline", file=sys.stderr, flush=True)
                self.kill()
                sys.stderr.flush()
                os._exit(1)

    def wait(self) -> List[str]:
        """Wait for every child to end (until the deadline); the failures,
        as notes."""
        notes = []
        for r, p in self.procs.items():
            try:
                code = p.wait(timeout=max(1.0, self.deadline - time.time()))
            except subprocess.TimeoutExpired:
                code = None
            if code != 0:
                self.report(r, code)
                notes.append(f"rank {r} ended with code {code}")
        self._done.set()
        self.kill()
        return notes


def run(ctx) -> Outcome:
    cfg = program_config(ctx.config)
    traffic = ctx.traffic
    ranks = int(traffic["ranks"])
    backend = traffic.get("backend", "nccl")
    per_rank = int(cfg["data_loader"]["args"]["batch_size"])
    n_check = int(traffic["check_steps"])
    if backend == "nccl":
        from demovlp_tpu_torch.ops import cuda_build

        cuda_build.build(["xattn_sim_fwd", "xattn_sim_bwd"])
    job = {"root": str(ctx.root), "config": cfg, "traffic": traffic, "seed": int(ctx.seed),
           "seconds": float(ctx.seconds), "ranks": ranks, "backend": backend,
           "port": free_port(), "t_start": ctx.t_start}
    job_file = ctx.out_dir / "dp_job.json"
    job_file.write_text(json.dumps(job))
    children = Ranks(job, job_file, ctx.out_dir)
    try:
        got = rank_run(job, 0, ctx.out_dir, ctx.trace)
    except BaseException:
        children.kill()
        raise
    notes = children.wait()

    # the reference over the compared steps' global batches
    device = ctx.device
    w = ref_model.Widths.from_config(cfg)
    inputs = data.Inputs(ctx.seed, int(traffic["samples_per_epoch"]), w.frames, w.regions,
                         device)
    batches = dp.global_batches(inputs, ctx.seed, ranks, per_rank, n_check)
    t_ref = time.perf_counter()
    p0 = got["p0"]
    if {n: tuple(v.shape) for n, v in p0.items()} != ref_model.param_shapes(w):
        notes.append("the program's parameters are not the configuration's (names or shapes)")
    if len(got["records"]) != n_check:
        notes.append(f"the program's local similarity ran {len(got['records'])} times in "
                     f"{n_check} compared steps")
    ref = dp.reference_train(cfg, ctx.seed, batches, p0, device, ranks,
                             int(traffic["local_block"]))
    detail: Dict[str, Any] = {}
    numbers = checks.compare_train(got["prog"], ref, p0, detail)
    numbers.update(dp.compare_local(got["records"], checks.loss_args(cfg), device,
                                    int(traffic["local_block"])))
    limits = traffic["limits"]
    batch = per_rank * ranks
    samples = got["steps"] * batch
    window = {
        "kind": "train", "units": samples, "steps": got["steps"], "window_s": got["window_s"],
        "data_waits_s": got["waits"], "xattn_launches": got["launches"],
        "xattn_items": lambda ls, lq: (batch, batch), "d": w.proj,
        "local_precision": cfg["loss"]["args"].get("local_dtype", "float32"),
        # the global step's model FLOPs a card, so that mfu.train (one
        # card's peak) reads the share of all the ranks' peak; the local
        # stage that every rank repeats counts once
        "flops_per_step": counts.retrieval_step(batch, w.frames, w.regions, data.TEXT_LEN,
                                                w.proj, w.obj_depth, w.obj_dim, w.text_layers,
                                                w.text_dim) / ranks,
        "device_name": got["info"]["kind"], "trace": got["trace"],
        "reference_s": time.perf_counter() - t_ref, "check_detail": detail,
    }
    return Outcome(setup_s=got["setup_s"],
                   end_to_end={"train_samples_per_s": samples / got["window_s"],
                               "setup_s": got["setup_s"]},
                   attempted=got["steps"],
                   failed=sum(not np.isfinite(x) for x in got["window_losses"]),
                   checks=[Check(k, float(v), float(limits[k])) for k, v in numbers.items()],
                   device=got["info"], window=window, notes=notes)


def main(argv=None) -> int:
    """A child rank: its part of the job, then exit 0."""
    p = argparse.ArgumentParser(description="one child rank of a data-parallel benchmark run")
    p.add_argument("--job", required=True)
    p.add_argument("--rank", required=True, type=int)
    args = p.parse_args(argv)
    job = json.loads(Path(args.job).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank_run(job, args.rank, Path(args.job).parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
