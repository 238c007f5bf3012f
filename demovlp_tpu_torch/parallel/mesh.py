"""Process groups, the (data, model) device mesh and the host gathers
(counterpart of demovlp_tpu/parallel/mesh.py).

One process per card, launched by torchrun:

    torchrun --nproc-per-node N -m demovlp_tpu_torch.cli.train -c <config>

`setup_distributed(backend)` reads torchrun's RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT; the caller names the backend (nccl on the
card, gloo on the CPU). `data_loader.args.batch_size` is the batch of one
process: the global batch is the concatenation of the data ranks'
batches in rank order, as JAX `shard_batch` assembles it and as the
reference's per-GPU contract has it. Ranks that share a data coordinate
(a tensor-parallel group over the `model` axis) read the same rows.

`host_allgather_ragged` and `host_allgather_pylist` take an injectable
`allgather`, as in the JAX package, so the CPU tests can simulate P
processes. The host gathers (text-bucket agreement, eval assembly) run
over gloo groups of their own, made beside the world group and each data
group: under nccl a host integer sent through the card would wait for
every kernel already queued, and the trainer's one-step-late read of the
metrics would be lost. At one process every helper here returns at once:
no collective and no copy.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# the gloo group that carries the host gathers of each group, keyed by the
# group's ranks (None: the world)
_HOST_GROUPS: dict = {}


def setup_distributed(backend: str) -> None:
    """Join torchrun's process group with `backend` ("nccl" or "gloo").
    A no-op where WORLD_SIZE is absent or 1, and when a group exists."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=world)
    _HOST_GROUPS.clear()
    _HOST_GROUPS[None] = _HOST_GROUPS[tuple(range(world))] = dist.new_group(backend="gloo")


def local_rank() -> int:
    """This process's card index on its host (torchrun's LOCAL_RANK)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0 keeps the logs, the writer, the visualizer and the files."""
    return process_index() == 0


def create_mesh(model: int = 1, device_type: str = "cuda"):
    """The (data, model) DeviceMesh over every process: `model` ranks a
    tensor-parallel group, world // model data-parallel replicas."""
    from torch.distributed.device_mesh import init_device_mesh

    world = process_count()
    if model < 1 or world % model:
        raise ValueError(f"mesh.model={model} does not divide the world size {world}")
    mesh = init_device_mesh(device_type, (world // model, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    if _HOST_GROUPS:
        # every process makes every data group's gloo twin, in one order
        for ranks in mesh.mesh.t().tolist():
            key = tuple(ranks)
            if len(key) > 1 and key not in _HOST_GROUPS:
                _HOST_GROUPS[key] = dist.new_group(list(key), backend="gloo")
    return mesh


def data_coords(mesh) -> tuple:
    """(data rank, data size): which loader shard this process reads.
    Without a mesh, (0, 1)."""
    if mesh is None:
        return 0, 1
    sub = mesh[DATA_AXIS]
    return sub.get_local_rank(), sub.size()


def data_group(mesh):
    """The data-parallel process group, or None without a mesh or where
    the data axis has one rank (nothing to reduce)."""
    if mesh is None or mesh[DATA_AXIS].size() == 1:
        return None
    return mesh[DATA_AXIS].get_group()


def data_allgather(mesh) -> Optional[Callable]:
    """The `allgather` of the host gathers over the data axis, or None
    without a mesh (one process: the gathers return their input). A data
    axis of one rank (a pure tensor-parallel mesh) gathers nothing."""
    if mesh is None:
        return None
    group = data_group(mesh)
    if group is None:
        return np.asarray
    return lambda x: host_allgather(x, group=group)


def sync_processes() -> None:
    """Barrier across processes (no-op at one process)."""
    if process_count() > 1:
        dist.barrier()


def host_group(group=None):
    """The gloo group that carries `group`'s host gathers (default: the
    world's); `group` itself where setup_distributed made none."""
    key = None if group is None else tuple(dist.get_process_group_ranks(group))
    return _HOST_GROUPS.get(key, group)


def host_allgather(x, group=None) -> np.ndarray:
    """Concatenate a host array across the group's processes (default: all)
    along axis 0, in rank order. Equal shapes on every process."""
    x = np.asarray(x)
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return x
    group = host_group(group)
    device = "cpu"
    if dist.get_backend(group) == "nccl":  # a group made without setup_distributed
        device = torch.device("cuda", torch.cuda.current_device())
    t = torch.tensor(x, device=device)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return np.concatenate([p.cpu().numpy() for p in parts], axis=0).reshape(-1, *x.shape[1:])


def host_allgather_ragged(x, allgather=None) -> np.ndarray:
    """Concatenate host arrays of unequal leading lengths across processes,
    in process order: gather the counts, pad every shard to the largest,
    gather, strip the pads."""
    if allgather is None:
        if process_count() == 1:
            return np.asarray(x)
        allgather = host_allgather
    x = np.asarray(x)
    counts = allgather(np.asarray([x.shape[0]], np.int64))
    cap = int(np.max(counts))
    if x.shape[0] < cap:
        pad = np.zeros((cap - x.shape[0], *x.shape[1:]), x.dtype)
        x = np.concatenate([x, pad], axis=0)
    gathered = allgather(x)
    parts = [gathered[p * cap: p * cap + int(c)] for p, c in enumerate(counts)]
    return np.concatenate(parts, axis=0)


def host_allgather_pylist(items, allgather=None) -> list:
    """Concatenate JSON-serialisable python lists across processes in
    process order (JSON -> utf-8 bytes -> the ragged gather), so they line
    up row for row with host_allgather_ragged's arrays."""
    if allgather is None:
        if process_count() == 1:
            return list(items)
        allgather = host_allgather
    payload = np.frombuffer(json.dumps(list(items)).encode("utf-8"), np.uint8)
    counts = allgather(np.asarray([payload.shape[0]], np.int64))
    cap = int(np.max(counts))
    if payload.shape[0] < cap:
        payload = np.concatenate([payload, np.zeros(cap - payload.shape[0], np.uint8)])
    gathered = allgather(payload)
    out = []
    for p, c in enumerate(counts):
        out.extend(json.loads(gathered[p * cap: p * cap + int(c)].tobytes().decode("utf-8")))
    return out


class _GatherRows(torch.autograd.Function):
    """All-gather equal row blocks along axis 0; the backward hands each
    rank its own slice of the gradient. Every rank computes the same loss
    on the gathered rows, so that slice is the whole gradient of its rows."""

    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.rank, ctx.rows = dist.get_rank(group), x.shape[0]
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The global batch's rows of `x` (this rank's rows in rank order),
    differentiable; `x` itself where `group` is None."""
    return x if group is None else _GatherRows.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of `x` over the group, as a new tensor; `x` where group is None."""
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x


def all_reduce_max_int(v: int) -> int:
    """The largest of an integer over the processes."""
    return int(host_allgather(np.asarray([v], np.int64)).max())


def reduce_gradients(params, group) -> None:
    """Sum every parameter's gradient over the data group in one flat
    collective, so the update equals the one-process update on the
    concatenated batch (each rank's loss is the global loss, and its
    gradient holds only its own rows' share). A parameter without a
    gradient takes zeros, so every rank reduces the same layout."""
    if group is None:
        return
    params = [p for p in params if p.requires_grad]
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        g = p.grad
        grads.append(g.to_local() if hasattr(g, "to_local") else g)
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n
