"""Tensor parallelism over the mesh's `model` axis (counterpart of
demovlp_tpu/parallel/tp.py), as a plan for
`torch.distributed.tensor.parallel.parallelize_module`.

Megatron splits of every transformer attention and MLP in both towers,
over the reference-schema module names:

  column (output features split): attention.{q_lin,k_lin,v_lin}, ffn.lin1,
                                  attn.qkv / timeattn.qkv, mlp.fc1
  row    (input features split):  attention.out_lin, ffn.lin2,
                                  attn.proj / timeattn.proj, mlp.fc2

Everything else is replicated, the towers' final `proj` and `txt_proj.1`
included. A column split leaves each rank its share of the heads (or of
the MLP's hidden units) as plain local tensors; the row split after it
takes them as `Shard(-1)` and all-reduces its partial sums, so the
residual stream stays replicated. An attention module or an MLP whose
split width does not divide the `model` axis stays replicated whole
(JAX tp.py:42-69 decides leaf by leaf; here a column split and the row
split that consumes it go together, and an attention module also needs
its head count to divide).

The fused `qkv` (models/object_transformer.py) is split per head: its
3*D output rows are permuted so that rank r's contiguous `Shard(0)` block
is [q_r; k_r; v_r], its own heads of each. A contiguous split of the
reference layout would hand rank 0 all of q and part of k; GSPMD hides
that in JAX (tp.py:22-30), DTensor does not. The attention modules count
their heads locally (local width // head dim), which is the full count
without this plan. The permutation lives only inside the sharded
parameter and its optimizer moments: `full_state_dict` and
`load_full_state_dict` speak the reference layout, so a TP checkpoint
loads into a model with no TP and back.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.tensor import DTensor, Shard, distribute_tensor
from torch.distributed.tensor.parallel import (ColwiseParallel, RowwiseParallel,
                                               parallelize_module)

from demovlp_tpu_torch.parallel.mesh import MODEL_AXIS


class FusedQKVColwise(ColwiseParallel):
    """Column split of a fused (3*D, D) q/k/v Linear, per head: the rows
    are permuted to [q_0; k_0; v_0; q_1; ...] before the Shard(0) split."""

    def _partition_linear_fn(self, name, module, device_mesh):
        perm = qkv_permutation(module.out_features, device_mesh.size())
        module._tp_qkv_perm = perm
        for pname, param in list(module.named_parameters()):
            with torch.no_grad():
                permuted = param[perm.to(param.device)]
            module.register_parameter(pname, nn.Parameter(
                distribute_tensor(permuted, device_mesh, [Shard(0)], src_data_rank=None),
                requires_grad=param.requires_grad))


def qkv_permutation(out_features: int, parts: int) -> torch.Tensor:
    """Row order of a fused qkv whose rank r holds its own q, k and v rows."""
    d = out_features // 3
    chunk = d // parts
    return torch.cat([torch.arange(s * d + r * chunk, s * d + (r + 1) * chunk)
                      for r in range(parts) for s in range(3)])


def _attention_splits(attn: nn.Module, heads: int, m: int) -> bool:
    dim = attn.proj.in_features if hasattr(attn, "proj") else attn.out_lin.in_features
    return dim % m == 0 and heads % m == 0


def tp_plan(model: nn.Module, model_size: int) -> Dict[str, object]:
    """{module path: ColwiseParallel / RowwiseParallel / FusedQKVColwise}
    over the model's reference-schema names; empty at model_size 1."""
    plan: Dict[str, object] = {}
    if model_size <= 1:
        return plan
    m = model_size
    for name, mod in model.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("attn", "timeattn") and hasattr(mod, "qkv"):
            if _attention_splits(mod, mod.num_heads, m):
                plan[f"{name}.qkv"] = FusedQKVColwise()
                plan[f"{name}.proj"] = RowwiseParallel()
        elif leaf == "attention" and hasattr(mod, "q_lin"):
            if _attention_splits(mod, mod.n_heads, m):
                for lin in ("q_lin", "k_lin", "v_lin"):
                    plan[f"{name}.{lin}"] = ColwiseParallel()
                plan[f"{name}.out_lin"] = RowwiseParallel()
        elif leaf == "mlp" and hasattr(mod, "fc1"):
            if mod.fc1.out_features % m == 0:
                plan[f"{name}.fc1"] = ColwiseParallel()
                plan[f"{name}.fc2"] = RowwiseParallel()
        elif leaf == "ffn" and hasattr(mod, "lin1"):
            if mod.lin1.out_features % m == 0:
                plan[f"{name}.lin1"] = ColwiseParallel()
                plan[f"{name}.lin2"] = RowwiseParallel()
    return plan


def apply_tp(model: nn.Module, mesh) -> nn.Module:
    """Shard `model` in place over the mesh's model axis (a no-op where it
    has one rank). Every rank must hold the same full weights: each keeps
    its own block, with no collective."""
    if mesh is None or mesh[MODEL_AXIS].size() == 1:
        return model
    sub = mesh[MODEL_AXIS]
    return parallelize_module(model, sub, tp_plan(model, sub.size()), src_data_rank=None)


def _perm_of(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{parameter name: row permutation} of the fused qkv splits."""
    return {f"{name}.{p}": mod._tp_qkv_perm for name, mod in model.named_modules()
            if hasattr(mod, "_tp_qkv_perm") for p, _ in mod.named_parameters(recurse=False)}


def full_tensor(param: torch.Tensor, local: torch.Tensor, perm=None) -> torch.Tensor:
    """The whole tensor in the reference layout from this rank's `local`
    block of a tensor laid out like `param` (an all-gather over the model
    axis where `param` is sharded; `local` itself where it is not).

    The blocks travel through `torch.distributed.all_gather`, not
    `DTensor.full_tensor`: the functional all_gather_into_tensor that the
    latter issues crashes the process under gloo with CUDA tensors (torch
    2.11, PERF.md)."""
    if not isinstance(param, DTensor):
        return local
    (placement,) = param.placements
    if not isinstance(placement, Shard):
        return local
    mesh = param.device_mesh
    parts = [torch.empty_like(local) for _ in range(mesh.size())]
    dist.all_gather(parts, local.contiguous(), group=mesh.get_group())
    full = torch.cat(parts, dim=placement.dim)
    if perm is not None:
        full = torch.empty_like(full).index_copy_(0, perm.to(full.device), full)
    return full


def local_block(param: torch.Tensor, full: torch.Tensor, perm=None) -> torch.Tensor:
    """This rank's block of a reference-layout tensor laid out like `param`."""
    if not isinstance(param, DTensor):
        return full
    if perm is not None:
        full = full[perm.to(full.device)]
    return distribute_tensor(full.to(param.device_mesh.device_type), param.device_mesh,
                             param.placements, src_data_rank=None).to_local()


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict whole, in the reference layout, copied to the
    host (a later in-place update does not reach it)."""
    perms = _perm_of(model)
    out = {}
    for k, v in model.state_dict().items():
        local = v.to_local() if isinstance(v, DTensor) else v
        out[k] = full_tensor(v, local.detach(), perms.get(k)).to("cpu", copy=True)
    return out


def load_full_state_dict(model: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Load a reference-layout state dict strictly into a model with or
    without the TP plan applied."""
    if not any(isinstance(p, DTensor) for p in model.parameters()):
        model.load_state_dict(state, strict=True)
        return
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise RuntimeError(f"state dict mismatch: missing {missing[:5]}, "
                           f"unexpected {unexpected[:5]}")
    perms = _perm_of(model)
    with torch.no_grad():
        for k, v in own.items():
            src = state[k]
            if tuple(src.shape) != tuple(v.shape):
                raise RuntimeError(f"{k}: shape {tuple(src.shape)} != {tuple(v.shape)}")
            dst = v.to_local() if isinstance(v, DTensor) else v
            dst.copy_(local_block(v, src.to(dst.device, dst.dtype), perms.get(k)))


def param_perms(model: nn.Module, params) -> list:
    """The qkv permutation (or None) of each parameter in `params` order."""
    perms = _perm_of(model)
    by_id = {id(p): perms.get(n) for n, p in model.named_parameters()}
    return [by_id.get(id(p)) for p in params]
