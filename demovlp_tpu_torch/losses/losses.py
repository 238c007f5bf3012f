"""Retrieval training objectives (counterpart of demovlp_tpu/losses/losses.py:
`norm_softmax_loss`, `rwa_loss`, `NormSoftmaxLoss`, `RWALoss`,
`GlobalLocalLoss`).

The local scores go through `ops.xattn_kernel.xattn_score_kernel`: on the
card the fused forward kernel and the two backward kernels, on the CPU
their plain versions. That is the JAX package's `ops.xattn_backend:
"pallas"` path; `local_dtype: "bfloat16"` selects the kernels' bf16 mode.
The XLA-backend bf16 pipeline, `local_block_segment` (blockwise scores)
and `local_remat` are not ported. The QA/MC losses wait for their slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from demovlp_tpu_torch.ops.xattn_kernel import xattn_score_kernel

_LOCAL_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def _neg_mask(valid: torch.Tensor, dtype) -> torch.Tensor:
    return torch.where(valid.bool(), 0.0, float("-inf")).to(dtype)


def norm_softmax_loss(sim: torch.Tensor, temperature: float = 0.05,
                      valid: torch.Tensor | None = None) -> torch.Tensor:
    """Bidirectional InfoNCE on a cosine-similarity matrix. `valid` (N,) 0/1
    masks rows and columns out: the result equals the loss of the valid
    rows alone."""
    if valid is None:
        i_logsm = torch.log_softmax(sim / temperature, dim=1)
        j_logsm = torch.log_softmax(sim.T / temperature, dim=1)
        return -torch.mean(torch.diagonal(i_logsm)) - torch.mean(torch.diagonal(j_logsm))
    vbool = valid.bool()
    neg = _neg_mask(valid, sim.dtype)
    i_logsm = torch.log_softmax(sim / temperature + neg[None, :], dim=1)
    j_logsm = torch.log_softmax(sim.T / temperature + neg[None, :], dim=1)
    n_valid = torch.sum(valid.to(sim.dtype))
    loss_i = torch.sum(torch.where(vbool, torch.diagonal(i_logsm), 0.0)) / n_valid
    loss_j = torch.sum(torch.where(vbool, torch.diagonal(j_logsm), 0.0)) / n_valid
    return -loss_i - loss_j


def rwa_loss(im, s, im_mask, s_mask=None, lambda_softmax: float = 20.0,
             focal_type: str = "prob", compute_dtype: torch.dtype | None = None,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """Region-word alignment loss: KL(softmax(lambda * scores) || ~identity),
    the labels entering as log(labels + 1e-6). im (B, R, D) regions, s
    (B, W, D) words, additive masks."""
    if s_mask is None:
        s_mask = torch.zeros(s.shape[:2], dtype=torch.float32, device=s.device)
    scores = xattn_score_kernel(im, s, im_mask, s_mask, lambda_softmax, focal_type,
                                compute_dtype)
    labels = torch.eye(im.shape[0], dtype=scores.dtype, device=scores.device)
    log_labels = torch.log(labels + 1e-6)
    if valid is None:
        logits = scores * lambda_softmax
        pred = torch.softmax(logits, dim=1)
        loss = pred * (torch.log_softmax(logits, dim=1) - log_labels)
        return torch.mean(torch.sum(loss, dim=1))
    vbool = valid.bool()
    logits = scores * lambda_softmax + _neg_mask(valid, scores.dtype)[None, :]
    pred = torch.softmax(logits, dim=1)  # masked columns -> exactly 0
    ldiff = torch.log_softmax(logits, dim=1) - log_labels
    # select BEFORE reading pred * ldiff at masked columns (0 * -inf = NaN)
    loss = torch.where(vbool[None, :], pred * torch.where(vbool[None, :], ldiff, 0.0), 0.0)
    row_loss = torch.sum(loss, dim=1)
    return torch.sum(torch.where(vbool, row_loss, 0.0)) / torch.sum(valid.to(scores.dtype))


@dataclass(frozen=True)
class NormSoftmaxLoss:
    temperature: float = 0.05

    def __call__(self, sim, valid=None):
        return norm_softmax_loss(sim, self.temperature, valid)


@dataclass(frozen=True)
class RWALoss:
    lambda_softmax: float = 20.0
    focal_type: str = "prob"
    margin: float = 0.0  # parity field; unused (the reference never uses it)
    max_violation: bool = False  # parity field; unused
    local_dtype: str = "float32"

    def __post_init__(self):
        if self.local_dtype not in _LOCAL_DTYPES:
            raise ValueError(f"local_dtype {self.local_dtype!r}: expected one of "
                             f"{sorted(_LOCAL_DTYPES)}")

    def __call__(self, im, s, im_mask, s_lens=None, s_mask=None, valid=None):
        # s_lens: accepted for call-surface parity, never used
        return rwa_loss(im, s, im_mask, s_mask, self.lambda_softmax, self.focal_type,
                        _LOCAL_DTYPES[self.local_dtype], valid)


@dataclass(frozen=True)
class GlobalLocalLoss:
    """Global InfoNCE + local RWA loss. `coef` is accepted and, as in the
    reference, never applied: the total is always global + local."""

    temperature: float = 0.05
    lambda_softmax: float = 20.0
    focal_type: str = "prob"
    margin: float = 0.0
    max_violation: bool = False
    use_local: bool = True
    use_global: bool = True
    coef: float = 1000.0
    local_block_segment: int = 0
    local_dtype: str = "float32"
    local_remat: bool = False
    global_loss: NormSoftmaxLoss = field(init=False)
    local_loss: RWALoss = field(init=False)

    def __post_init__(self):
        if self.local_block_segment or self.local_remat:
            raise NotImplementedError(
                "local_block_segment and local_remat (XLA-path options) are not ported"
            )
        object.__setattr__(self, "global_loss", NormSoftmaxLoss(self.temperature))
        object.__setattr__(self, "local_loss", RWALoss(
            self.lambda_softmax, self.focal_type, self.margin, self.max_violation,
            self.local_dtype))

    def __call__(self, global_sim, local_im, local_s, local_im_mask, local_s_lens,
                 local_s_mask, valid=None):
        """(total, global, local)."""
        zero = torch.zeros((), dtype=global_sim.dtype, device=global_sim.device)
        if not self.use_local:
            g = self.global_loss(global_sim, valid)
            return g, g, zero
        l = self.local_loss(local_im, local_s, local_im_mask, local_s_lens, local_s_mask,
                            valid)
        if not self.use_global:
            return l, zero, l
        g = self.global_loss(global_sim, valid)
        return g + l, g, l
