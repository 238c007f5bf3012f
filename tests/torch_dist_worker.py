"""Multi-process helpers for tests/test_torch_{dist,tp}.py: tiny port models,
seeded batches, and the bodies that each gloo process runs on the CPU.

Imported by spawned processes, so it imports torch and the port only (no
JAX). Each process writes what it measured to `<out>/rank<r>.pt`; the
test compares that with the one-process run in the parent.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import socket
import traceback

import numpy as np
import torch

from demovlp_tpu_torch.losses.losses import CrossEntropy, GlobalLocalLoss
from demovlp_tpu_torch.models import DistilBertConfig, ObjectQARelation, ObjectRelation

F, K, L, B = 2, 4, 12, 8  # frames, regions, text length, global batch
TEXT = dict(vocab_size=1200, dim=32, n_layers=2, n_heads=4, hidden_dim=64,
            max_position_embeddings=128, dropout=0.0, attention_dropout=0.0)


def tiny_model(kind: str = "retrieval", mlm: bool = False, seed: int = 0, hidden: int = 64):
    """A two-layer model of each tower at width 32 (f32, dropout off), the
    region tower with time attention; seeded init."""
    kw = dict(object_num=K, num_frames=F, time_module="timeattn", projection_dim=16,
              text_config=DistilBertConfig(**{**TEXT, "hidden_dim": hidden}),
              object_embed_dim=32, object_depth=2, object_heads=4)
    if kind == "qa":
        model = ObjectQARelation(num_label=10, head_dropout=0.0, **kw)
    else:
        model = ObjectRelation(with_mlm=mlm, **kw)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


def loss_obj():
    return GlobalLocalLoss(use_local=True, use_global=True, focal_type="prob")


def make_batch(seed: int, b: int = B, mlm: bool = False, qa: bool = False):
    """A numpy batch with ragged text lengths and region masks."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(4, L + 1, size=b)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int64)
    ids = rng.integers(1, TEXT["vocab_size"], size=(b, L)) * mask
    om = (rng.random((b, F, K)) < 0.8).astype(np.float32)
    om[:, :, 0] = 1.0
    out = {"input_ids": ids, "attention_mask": mask,
           "object": rng.standard_normal((b, F, K, 2054)).astype(np.float32),
           "object_mask": om}
    if mlm:
        labels = np.where((rng.random((b, L)) < 0.3) & (mask > 0), ids, -100)
        out["mlm_labels"] = labels
    if qa:
        out["label"] = rng.integers(0, 10, size=b)
    return out


def rows(batch, lo: int, hi: int):
    return {k: v[lo:hi] for k, v in batch.items()}


def synthetic_loader(n: int, process_index: int, process_count: int):
    """An eval loader over n synthetic samples, batch 4, this process's shard."""
    from demovlp_tpu_torch.data.datasets import dataset_object_loader
    from demovlp_tpu_torch.data.loader import RegionDataLoader
    ds = dataset_object_loader("SyntheticObjectSelect", text_params={}, split="test",
                               object_params={"num_frames": F, "object_num": K,
                                              "num_samples": n})
    return RegionDataLoader(ds, batch_size=4, shuffle=False, num_workers=1, drop_last=False,
                            process_index=process_index, process_count=process_count)


def tokenizer():
    from demovlp_tpu_torch.data.tokenizer import SimpleTokenizer
    return SimpleTokenizer(vocab_size=TEXT["vocab_size"])


def embed_and_score(model, mesh, d: int, n: int) -> dict:
    """embed_loader over a 9-sample loader's shard and the combined sims."""
    from demovlp_tpu_torch.serve import combined_sims, embed_loader, make_embed_step
    cat, meta = embed_loader(make_embed_step(model), synthetic_loader(9, d, n), tokenizer(),
                             torch.device("cpu"), mesh=mesh)
    return {"cat": cat, "meta": meta, "sims": combined_sims(cat, "cpu", mesh=mesh)}


def to_torch(batch):
    from demovlp_tpu_torch.train.steps import batch_to_device
    return batch_to_device(batch, torch.device("cpu"))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(fn, rank, world, port, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    try:
        from demovlp_tpu_torch.parallel.mesh import setup_distributed
        setup_distributed("gloo")
        fn(rank, *args)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, *args, timeout: float = 120.0) -> None:
    """Run fn(rank, *args) in `world` spawned gloo processes; each is
    killed at `timeout` s. Raises when a process fails or times out."""
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(fn, r, world, port, args)) for r in range(world)]
    for p in procs:
        p.start()
    failed = []
    for r, p in enumerate(procs):
        p.join(timeout)
        if p.is_alive():
            p.kill()
            p.join(10)
            failed.append(f"rank {r} timed out after {timeout} s")
        elif p.exitcode != 0:
            failed.append(f"rank {r} exit code {p.exitcode}")
    if failed:
        raise RuntimeError("; ".join(failed))


# ------------------------------------------------------------ the bodies
def dp_cases(rank: int, out: str, init: dict) -> None:
    """Data parallel over 2 ranks (mesh (2, 1)): each rank feeds rows
    [4r, 4r + 4) of every global batch."""
    from demovlp_tpu_torch.cli.common import build_optimizer
    from demovlp_tpu_torch.parallel.mesh import create_mesh, data_coords
    from demovlp_tpu_torch.train.steps import (make_qa_train_step, make_retrieval_eval_step,
                                               make_retrieval_train_step)
    mesh = create_mesh(1, "cpu")
    d, n = data_coords(mesh)
    lo, hi = d * B // n, (d + 1) * B // n
    res = {}
    for case, (model, opt_args, step_kind) in case_table(init).items():
        opt = build_optimizer({"optimizer": {"type": "AdamW", "args": opt_args}},
                              model.parameters())
        if step_kind == "qa":
            step = make_qa_train_step(model, CrossEntropy(), opt, deterministic=True, mesh=mesh)
        else:
            step = make_retrieval_train_step(model, loss_obj(), opt, deterministic=True,
                                             mlm_weight=0.5 if step_kind == "mlm" else 0.0,
                                             mesh=mesh)
        res[case] = run_steps(model, step, step_kind, lo, hi)
    # eval: a global batch of 8 rows whose last 2 (on rank 1) are pads
    model = tiny_model()
    model.load_state_dict(init["retrieval"])
    batch = make_batch(7)
    batch["valid"] = (np.arange(B) < 6).astype(np.float32)
    _, losses = make_retrieval_eval_step(model, loss_obj(), mesh=mesh)(to_torch(rows(batch, lo, hi)))
    res["eval"] = [float(x) for x in losses]
    res["serve"] = embed_and_score(model, mesh, d, n)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def case_table(init: dict):
    """{case: (model with the case's initial weights, optimizer args, step kind)}."""
    table = {}
    for case, kind, opt_args, step_kind in (
            ("plain", "retrieval", {"lr": 1e-3}, "retrieval"),
            ("clip", "retrieval", {"lr": 1e-3, "max_grad_norm": 0.05}, "retrieval"),
            ("mlm", "mlm", {"lr": 1e-3}, "mlm"),
            ("qa", "qa", {"lr": 1e-3}, "qa")):
        model = tiny_model("qa" if kind == "qa" else "retrieval", mlm=kind == "mlm")
        model.load_state_dict(init[kind])
        table[case] = (model, opt_args, step_kind)
    return table


def run_steps(model, step, step_kind: str, lo: int, hi: int) -> dict:
    """Two steps on global batches 1 and 2 (rows [lo, hi)): each step's
    metrics, the gradients of step 1, the parameters after step 2."""
    metrics, grads = [], None
    for i in (1, 2):
        batch = make_batch(i, mlm=step_kind == "mlm", qa=step_kind == "qa")
        m = step(to_torch(rows(batch, lo, hi)), 1e-3)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 1:
            grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                     if p.grad is not None}
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return {"metrics": metrics, "grads": grads, "params": params}


def bucket_case(rank: int, out: str) -> None:
    """prepare_batch on two ranks whose longest captions fall in different
    buckets: both trim to the larger."""
    from demovlp_tpu_torch.data.tokenizer import SimpleTokenizer
    from demovlp_tpu_torch.train.steps import prepare_batch
    words = 5 if rank == 0 else 20
    data = {"text": [" ".join(["a"] * words), "b"], "object": np.zeros((2, F, K, 2054)),
            "object_mask": np.ones((2, F, K))}
    arrays = prepare_batch(data, SimpleTokenizer(max_length=100), text_buckets=[8, 16, 32])
    torch.save(arrays["input_ids"].shape[1], os.path.join(out, f"rank{rank}.pt"))


def host_group_case(rank: int, out: str) -> None:
    """Mesh (2, 2) on four ranks: the world's and each data group's host
    gathers run on gloo groups of their own, in rank order."""
    import torch.distributed as dist

    from demovlp_tpu_torch.parallel.mesh import (all_reduce_max_int, create_mesh, data_group,
                                                 host_allgather, host_group)
    mesh = create_mesh(2, "cpu")
    group = data_group(mesh)
    world_host, data_host = host_group(), host_group(group)
    torch.save({"world_own": world_host is not None and world_host is not dist.group.WORLD,
                "data_own": data_host is not group,
                "backends": [dist.get_backend(world_host), dist.get_backend(data_host)],
                "data_ranks": dist.get_process_group_ranks(data_host),
                "gathered": host_allgather(np.asarray([rank]), group).tolist(),
                "max": all_reduce_max_int(rank)},
               os.path.join(out, f"rank{rank}.pt"))


def checkpoint_case(rank: int, out: str, init: dict, model_axis: int) -> None:
    """One step, a save (rank 0 writes), a fresh model restored on every
    rank; each rank reports its restored weights and optimizer count."""
    from demovlp_tpu_torch.cli.common import build_optimizer
    from demovlp_tpu_torch.parallel.mesh import create_mesh, data_coords
    from demovlp_tpu_torch.parallel.tp import apply_tp, full_state_dict
    from demovlp_tpu_torch.train.checkpoint import CheckpointManager
    from demovlp_tpu_torch.train.steps import make_retrieval_train_step
    mesh = create_mesh(model_axis, "cpu")
    d, n = data_coords(mesh)
    lo, hi = d * B // n, (d + 1) * B // n

    def fresh():
        model = tiny_model()
        model.load_state_dict(init["retrieval"])
        model = apply_tp(model, mesh)
        return model, build_optimizer({"optimizer": {"type": "AdamW", "args": {"lr": 1e-3}}},
                                      model.parameters())

    model, opt = fresh()
    step = make_retrieval_train_step(model, loss_obj(), opt, deterministic=True, mesh=mesh)
    step(to_torch(rows(make_batch(1), lo, hi)), 1e-3)
    mgr = CheckpointManager(os.path.join(out, "ckpt"), arch="ObjectRelation")
    path = mgr.save(model, opt, epoch=1, monitor_best=0.5)
    saved = {k: v.clone() for k, v in full_state_dict(model).items()}
    model2, opt2 = fresh()
    meta = mgr.restore(path, model2, opt2)
    restored = {k: v.clone() for k, v in full_state_dict(model2).items()}
    # a second step from the restored state equals a second step from the live one
    step2 = make_retrieval_train_step(model2, loss_obj(), opt2, deterministic=True, mesh=mesh)
    b2 = to_torch(rows(make_batch(2), lo, hi))
    m_live, m_restored = float(step(b2, 1e-3)["loss"]), float(step2(b2, 1e-3)["loss"])
    torch.save({"saved": saved, "restored": restored, "epoch": meta["epoch"],
                "count": opt2.step_count, "live": m_live, "resumed": m_restored,
                "live_params": full_state_dict(model), "resumed_params": full_state_dict(model2)},
               os.path.join(out, f"rank{rank}.pt"))


def tp_case(rank: int, out: str, init: dict) -> None:
    """One train step at mesh (1, 2): both ranks feed the whole batch."""
    from demovlp_tpu_torch.cli.common import build_optimizer
    from demovlp_tpu_torch.parallel.mesh import create_mesh
    from demovlp_tpu_torch.parallel.tp import apply_tp, full_state_dict, full_tensor, param_perms
    from demovlp_tpu_torch.train.steps import make_retrieval_train_step
    mesh = create_mesh(2, "cpu")
    model = tiny_model()
    model.load_state_dict(init["retrieval"])
    model = apply_tp(model, mesh)
    opt = build_optimizer({"optimizer": {"type": "AdamW",
                                         "args": {"lr": 1e-3, "max_grad_norm": 0.05}}},
                          model.parameters())
    step = make_retrieval_train_step(model, loss_obj(), opt, deterministic=True, mesh=mesh)
    m = step(to_torch(make_batch(1)), 1e-3)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    grads = {n: full_tensor(p, p.grad.to_local() if hasattr(p.grad, "to_local") else p.grad,
                            perm).detach()
             for n, p, perm in zip(names, params, param_perms(model, params))}
    placements = {n: [str(pl) for pl in p.placements] if hasattr(p, "placements") else []
                  for n, p in model.named_parameters()}
    torch.save({"metrics": {k: float(v) for k, v in m.items()}, "grads": grads,
                "params": full_state_dict(model), "placements": placements},
               os.path.join(out, f"rank{rank}.pt"))



def dropout_case(rank: int, out: str, model_axis: int) -> None:
    """One train step with dropout on (p = 0.5 in the text tower) at mesh
    (2 / model_axis, model_axis), every rank feeding the same rows: each
    rank reports where its embedding dropout zeroed the input."""
    from demovlp_tpu_torch.cli.common import build_optimizer
    from demovlp_tpu_torch.parallel.mesh import create_mesh
    from demovlp_tpu_torch.parallel.tp import apply_tp
    from demovlp_tpu_torch.train.steps import make_retrieval_train_step
    mesh = create_mesh(model_axis, "cpu")
    model = ObjectRelation(object_num=K, num_frames=F, projection_dim=16, object_embed_dim=32,
                           object_depth=1, object_heads=4,
                           text_config=DistilBertConfig(**{**TEXT, "dropout": 0.5}))
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = apply_tp(model, mesh)
    zeros = []
    model.text_model.embeddings.dropout.register_forward_hook(
        lambda mod, args, y: zeros.append((y == 0).clone()))
    opt = build_optimizer({"optimizer": {"type": "AdamW", "args": {"lr": 1e-3}}},
                          model.parameters())
    step = make_retrieval_train_step(model, loss_obj(), opt, mesh=mesh, dropout_seed=3)
    step(to_torch(rows(make_batch(1), 0, B // 2)), 1e-3)
    torch.save(zeros[0], os.path.join(out, f"rank{rank}.pt"))
