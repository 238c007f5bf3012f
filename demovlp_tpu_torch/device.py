"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. With no
card and no CPU request they raise: nothing falls back to the CPU silently.
Under torchrun the card is the local rank's, `cuda:LOCAL_RANK`, made the
current device so that the kernels' launches go to it.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` -> cuda, `cuda:LOCAL_RANK` under torchrun (raises when no card
    is visible); else the named device."""
    if device is None:
        device = f"cuda:{os.environ['LOCAL_RANK']}" if "LOCAL_RANK" in os.environ else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU"
        )
    if dev.index is not None:
        torch.cuda.set_device(dev)
    # f32 paths are full f32: no TF32 in matmuls or convolutions, so the
    # card computes what the CPU reference computes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def to_device(x: np.ndarray, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Host array -> tensor on `device`, cast on the host first when `dtype`
    is given. To a card it goes through pinned memory without blocking, so
    the upload overlaps the kernels already queued."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
