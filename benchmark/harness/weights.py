"""Seeded weights, made on the device in a few large calls.

Both sides of a comparison take their weights from `init_params`: the
program's model (built on the meta device, then given storage on the card)
and the plain reference (a dict of tensors under the same names). The rule
is by name and shape only, so the two get equal values:

  * a 1-D `...weight` (every one is a LayerNorm's scale): 1;
  * a 1-D `...bias`: 0;
  * a 2-D matrix (a Linear's (out, in) kernel or an embedding table
    (rows, dim)): normal with std 1 / sqrt(shape[1]);
  * a 3-D tensor (CLS token, position and temporal embeds): normal with
    std 0.02.

The normal draws of all matrices and 3-D tensors come from one
`torch.randn` over their total size, in the order of their sorted names,
from a generator on the device seeded with the run's seed.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

_STD_3D = 0.02


def _std(name: str, shape: Tuple[int, ...]) -> float:
    if len(shape) == 2:
        return 1.0 / math.sqrt(shape[1])
    if len(shape) == 3:
        return _STD_3D
    raise ValueError(f"no initialisation rule for {name} of shape {shape}")


def init_params(named: Iterable[Tuple[str, torch.Tensor]], seed: int) -> None:
    """Fill the tensors of `named` in place from `seed` (module docstring).
    Every tensor lives on one device; the draws are made there."""
    named = sorted(named, key=lambda kv: kv[0])
    if not named:
        raise ValueError("no parameters to initialise")
    device = named[0][1].device
    drawn = [(n, t) for n, t in named if t.dim() >= 2]
    with torch.no_grad():
        for name, t in named:
            if t.device != device:
                raise ValueError(f"{name} is on {t.device}, the others on {device}")
            if t.dim() == 1:
                if name.endswith("weight"):
                    t.fill_(1.0)
                elif name.endswith("bias"):
                    t.zero_()
                else:
                    raise ValueError(f"no initialisation rule for 1-D {name}")
            elif t.dim() not in (2, 3):
                raise ValueError(f"no initialisation rule for {name} of shape {tuple(t.shape)}")
        if not drawn:
            return
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        total = sum(t.numel() for _, t in drawn)
        flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
        parts = list(torch.split(flat, [t.numel() for _, t in drawn]))
        parts = [p.view(t.shape) for p, (_, t) in zip(parts, drawn)]
        torch._foreach_mul_(parts, [_std(n, tuple(t.shape)) for n, t in drawn])
        torch._foreach_copy_([t for _, t in drawn], parts)
        del flat, parts


def params_on(shapes: Dict[str, Tuple[int, ...]], seed: int,
              device: torch.device) -> Dict[str, torch.Tensor]:
    """A fresh dict of f32 tensors of `shapes` on `device`, initialised by
    `init_params`."""
    out = {n: torch.empty(s, dtype=torch.float32, device=device) for n, s in shapes.items()}
    init_params(out.items(), seed)
    return out
