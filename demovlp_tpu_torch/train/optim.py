"""AdamW and the epoch learning-rate schedule (counterpart of
demovlp_tpu/train/optim.py: `make_optimizer`, `_reference_adamw_core`,
`step_decay_lr`). `AdamW` takes `make_optimizer`'s arguments.

Defaults are the JAX package's (transformers' AdamW): betas 0.9/0.999,
eps 1e-6, weight_decay 0.0 — not torch.optim.AdamW's 1e-8 / 0.01. Two
update forms:

  * default, optax.adamw: m_hat / (sqrt(v_hat) + eps), then + wd * p, all
    scaled by -lr;
  * `reference_exact`, transformers 4.10: the bias correction is a step-size
    factor over the UNcorrected denominator, and the decay applies to the
    post-step parameter at the raw lr.

`max_grad_norm` clips as optax.clip_by_global_norm does: g / |g| * max when
|g| >= max. `mu_dtype` is the storage dtype of the first moment (the update
itself reads the f32 moment before it is stored). `pack_small` is accepted
and changes nothing: it is numerically exact in the JAX package, and here
every update already runs as a few multi-tensor (foreach) kernels.
The learning rate is set per epoch (`set_lr`). A parameter split by the
tensor-parallel plan (parallel/tp.py) is updated through this rank's block,
and the clip norm counts every block once.
"""
from __future__ import annotations

import math
from typing import Iterable, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

_DTYPES = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16}


def _f32(x: float) -> float:
    """x rounded to f32."""
    return float(np.float32(x))


def step_decay_lr(epoch: int, base_lr: float, lr1: float, milestones: Sequence[int],
                  lr_mode: str = "reference") -> float:
    """The lr used DURING `epoch` (1-indexed). "reference" reproduces the
    reference's end-of-epoch reset: epoch 1 at the config lr, later epochs
    at lr1 * 0.1^(milestones passed by the previous epoch). "config" decays
    the config lr at the milestones instead."""
    if lr_mode == "reference":
        if epoch <= 1:
            return base_lr
        lr = lr1
        for m in milestones:
            if (epoch - 1) >= m:
                lr *= 0.1
        return lr
    lr = base_lr
    for m in milestones:
        if epoch > m:
            lr *= 0.1
    return lr


def _tp_global_norm(grads, is_sharded, group) -> torch.Tensor:
    """The global gradient norm with tensor-parallel blocks: each rank's
    blocks' squares summed over the model group, replicated tensors once."""
    sq = [n * n for n in torch._foreach_norm(grads)]
    zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    shard_sq = sum((s for s, sh in zip(sq, is_sharded) if sh), zero)
    dist.all_reduce(shard_sq, group=group)
    return torch.sqrt(sum((s for s, sh in zip(sq, is_sharded) if not sh), zero) + shard_sq)


class AdamW(torch.optim.Optimizer):
    """AdamW over one parameter group, in the JAX package's two forms.
    A parameter without a gradient takes a zero gradient, as a JAX gradient
    tree holds zeros for unused parameters."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-5, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6, weight_decay: float = 0.0,
                 max_grad_norm: float | None = None, mu_dtype: str | None = None,
                 pack_small: bool = False, reference_exact: bool = False):
        if mu_dtype not in _DTYPES:
            raise ValueError(f"mu_dtype {mu_dtype!r}: expected one of {sorted(map(str, _DTYPES))}")
        defaults = dict(lr=float(lr), b1=float(b1), b2=float(b2), eps=float(eps),
                        weight_decay=float(weight_decay), max_grad_norm=max_grad_norm,
                        mu_dtype=mu_dtype, reference_exact=bool(reference_exact))
        super().__init__(params, defaults)
        if len(self.param_groups) != 1:
            raise ValueError("AdamW takes one parameter group")

    @property
    def lr(self) -> float:
        return self.param_groups[0]["lr"]

    def set_lr(self, lr: float) -> None:
        self.param_groups[0]["lr"] = float(lr)

    @property
    def step_count(self) -> int:
        """Updates taken so far (0 before the first; restored with the
        state dict), a host integer: reading it never waits for the card."""
        params = self.param_groups[0]["params"]
        return int(self.state.get(params[0], {}).get("count", 0)) if params else 0

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("closures are not supported")
        group = self.param_groups[0]
        params = group["params"]
        if not params:
            return
        lr, b1, b2, eps, wd = (group[k] for k in ("lr", "b1", "b2", "eps", "weight_decay"))
        sharded = [p for p in params if isinstance(p, DTensor)]
        # a tensor-parallel parameter (parallel/tp.py) is updated through
        # this rank's block; its moments are blocks too
        params = [p.to_local() if isinstance(p, DTensor) else p for p in params]
        grads = [(g.to_local() if isinstance(g, DTensor) else g).float() if g is not None
                 else torch.zeros_like(p, dtype=torch.float32)
                 for p, g in zip(params, (p.grad for p in group["params"]))]
        max_norm = group["max_grad_norm"]
        if max_norm:
            if sharded:
                norm = _tp_global_norm(grads, [isinstance(p, DTensor) for p in group["params"]],
                                       sharded[0].device_mesh.get_group())
            else:
                norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            # optax: keep g below the limit, else (g / |g|) * max; chosen
            # on the device (dividing and multiplying by 1 is exact)
            below = norm < max_norm
            grads = torch._foreach_div(grads, torch.where(below, 1.0, norm))
            torch._foreach_mul_(grads, torch.where(below, 1.0, float(max_norm)))
        mu_dtype = _DTYPES[group["mu_dtype"]]
        states = [self.state[p] for p in group["params"]]
        for p, st in zip(params, states):
            if not st:
                st["mu"] = torch.zeros_like(p, dtype=mu_dtype or p.dtype)
                st["nu"] = torch.zeros_like(p)
        count = int(states[0].get("count", 0)) + 1
        # the stored first moment is upcast before b1 m: JAX's injected b1
        # is an f32 array, so its product with a bf16 moment is f32, and
        # 1 - b1 is taken in f32 as well
        mu = torch._foreach_mul([st["mu"].float() for st in states], b1)
        nu = [st["nu"] for st in states]
        torch._foreach_add_(mu, grads, alpha=_f32(1.0 - _f32(b1)))
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=_f32(1.0 - _f32(b2)))
        bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
        if group["reference_exact"]:
            step_size = lr * math.sqrt(bc2) / bc1
            den = torch._foreach_add(torch._foreach_sqrt(nu), eps)
            delta = torch._foreach_div(mu, den)
            torch._foreach_mul_(delta, -step_size)
            # decay on the POST-step parameter: p + delta - lr wd (p + delta)
            torch._foreach_add_(params, delta)
            if wd:
                torch._foreach_mul_(params, 1.0 - lr * wd)
        else:
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, den)
            if wd:
                torch._foreach_add_(upd, params, alpha=wd)
            torch._foreach_add_(params, upd, alpha=-lr)
        for st, m, v in zip(states, mu, nu):
            st["mu"] = m.to(mu_dtype) if mu_dtype is not None else m
            st["nu"] = v
            st["count"] = count

