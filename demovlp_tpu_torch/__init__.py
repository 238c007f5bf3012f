"""PyTorch/CUDA port of demovlp_tpu's retrieval serving path.

The JAX package `demovlp_tpu` is the reference this package is held
against; nothing here imports it (or JAX). Module names mirror the JAX
package so each counterpart is easy to find. The fused local-similarity
forward runs as a hand-written CUDA kernel (csrc/xattn_sim_fwd.cu) on the
card; every other op is plain PyTorch.
"""
from demovlp_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
