"""Plain PyTorch reference of DemoVLP's objectives and AdamW: the global
InfoNCE over cosine similarities, the local region-word alignment (RWA)
similarity and its KL loss, and optax's AdamW update.

The local similarity of one direction, for query items attending over
context items (query words over a video's regions, or the reverse):

    qn, cn = q / (|q| + 1e-8), c / (|c| + 1e-8)       per position
    a      = leaky_relu(qn . cn, 0.1)                  (Bc, Bq, Lq, Ls)
    a      = a / (sqrt(sum_Lq a^2) + 1e-8)             l2norm over the query axis
    p      = softmax(lambda * (a + context mask))      over Ls
    focal "equal": keep p where p > mean_Ls(p), renormalise
    w      = p @ cn                                    (Bc, Bq, Lq, D)
    sim    = mean_Lq  (w . q) / max(|w| |q|, 1e-8)

and the symmetric score of (images, captions) is t2i^T + i2t. `op` rounds
the operands of the two products, for the controls (precision.py).
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

Op = Callable[[torch.Tensor], torch.Tensor]
EPS = 1e-8


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def cosine_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Na, Nb) cosines, each norm floored at 1e-8."""
    a = a / torch.clamp(torch.linalg.norm(a, dim=1, keepdim=True), min=EPS)
    b = b / torch.clamp(torch.linalg.norm(b, dim=1, keepdim=True), min=EPS)
    return a @ b.T


def info_nce(sim: torch.Tensor, temperature: float = 0.05) -> torch.Tensor:
    """Bidirectional InfoNCE on a square similarity matrix."""
    i = torch.log_softmax(sim / temperature, dim=1)
    j = torch.log_softmax(sim.T / temperature, dim=1)
    return -torch.mean(torch.diagonal(i)) - torch.mean(torch.diagonal(j))


def direction_sim(context, query, ctx_mask, lam: float, focal_equal: bool,
                  op: Op = _identity) -> torch.Tensor:
    """(Bc, Bq) local similarity of one direction (module docstring)."""
    ls, lq = context.shape[1], query.shape[1]
    qn = query / (torch.linalg.norm(query, dim=-1, keepdim=True) + EPS)
    cn = context / (torch.linalg.norm(context, dim=-1, keepdim=True) + EPS)
    a = torch.einsum("qld,csd->cqls", op(qn), op(cn))
    a = F.leaky_relu(a, 0.1)
    a = a / (torch.sqrt(torch.sum(a * a, dim=2, keepdim=True)) + EPS)
    p = torch.softmax(lam * (a + ctx_mask[:, None, None, :]), dim=-1)
    if focal_equal:
        keep = (p * ls - torch.sum(p, -1, keepdim=True)) > 0
        p = torch.where(keep, p, 0.0)
        p = p / torch.sum(p, -1, keepdim=True)
    wv = torch.einsum("cqls,csd->cqld", op(p), op(cn))
    num = torch.sum(wv * query[None], -1)
    den = torch.linalg.norm(wv, dim=-1) * torch.linalg.norm(query, dim=-1)[None]
    return torch.sum(num / torch.clamp(den, min=EPS), -1) / lq


def local_scores(images, captions, img_mask, cap_mask, lam: float = 20.0,
                 focal_equal: bool = True, op: Op = _identity, block: int = 0) -> torch.Tensor:
    """(n_images, n_captions) symmetric local scores t2i^T + i2t; with
    `block`, computed in blocks of `block` items a side (the same values,
    less memory)."""
    if not block:
        i2t = direction_sim(images, captions, img_mask, lam, focal_equal, op)
        t2i = direction_sim(captions, images, cap_mask, lam, focal_equal, op)
        return t2i.T + i2t
    rows = []
    for i in range(0, images.shape[0], block):
        cols = [local_scores(images[i:i + block], captions[j:j + block], img_mask[i:i + block],
                             cap_mask[j:j + block], lam, focal_equal, op)
                for j in range(0, captions.shape[0], block)]
        rows.append(torch.cat(cols, 1))
    return torch.cat(rows, 0)


def rwa_loss(scores: torch.Tensor, lam: float = 20.0) -> torch.Tensor:
    """KL(softmax(lambda scores) || ~identity), labels entering as
    log(I + 1e-6), the mean over rows."""
    logits = scores * lam
    log_labels = torch.log(torch.eye(scores.shape[0], device=scores.device) + 1e-6)
    pred = torch.softmax(logits, dim=1)
    return torch.mean(torch.sum(pred * (torch.log_softmax(logits, dim=1) - log_labels), dim=1))


class AdamW:
    """optax.adamw over a dict of float32 tensors: m_hat / (sqrt(v_hat) +
    eps) + wd p, scaled by -lr."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, b1: float, b2: float,
                 eps: float, weight_decay: float):
        self.params = params
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.count += 1
        bc1, bc2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            upd = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + self.eps)
            if self.wd:
                upd = upd + self.wd * p
            p.add_(upd, alpha=-self.lr)


def leaf_norms(tensors: Dict[str, torch.Tensor], names: List[str]) -> List[float]:
    """The 2-norm of each named tensor, in float64 on the host."""
    return [float(torch.linalg.vector_norm(tensors[n].double())) for n in names]
