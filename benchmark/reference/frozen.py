"""Plain PyTorch reference of Frozen in Time (Bain, Nagrani, Varol,
Zisserman, ICCV 2021, arXiv:2104.00650; github.com/m-bain/frozen-in-time
`FrozenInTime`, `SpaceTimeTransformer`, `NormSoftmaxLoss`): plain
functions over a dict of float32 tensors keyed by the parameters' names.
No kernel, no cache; nothing of the program it checks is imported.

Video tower: uint8 frames (B, F, 3, R, R) -> x / 255 normalised by
ImageNet's mean and std -> the patch embedding as Frozen computes it, a
Conv2d(3, D, P, stride P) over each frame (its kernel is the parameter
`video_model.patch_embed.proj.weight` (D, 3 P P) reshaped) -> CLS +
pos_embed[0], patches + pos_embed[1:] tiled over the frames + the temporal
embed repeated over each frame's patches -> `depth` blocks of divided
attention -> final LayerNorm (eps 1e-6) -> the CLS row -> `vid_proj`.

A block, as Frozen's SpaceTimeBlock ("frozen-in-time" style):

    t = x + TimeAttn(norm3(x));  s = x + SpaceAttn(norm1(t));
    out = s + MLP(norm2(s))

Divided attention, written as Frozen's VarAttention: the CLS query attends
over every token; every other query attends over the CLS key and the keys
of its own group, one softmax a group: time groups are the F tokens of one
patch position, space groups the N patches of one frame.

Text tower: DistilBERT (dropout where its layers have it, from the masks
handed in) -> the CLS row -> ReLU -> `txt_proj`. Loss: NormSoftmax
(bidirectional InfoNCE) over the cosine similarities of the two global
embeddings at temperature 0.05.

`op` rounds every product operand: identity for the float32 reference, a
lower precision for a control. Everything else (norms, softmax, GELU,
residuals) is float32. `loss_and_grads` works the backward out a chunk of
videos at a time, so a batch whose video activations do not fit at once
can be differentiated: the embeddings without a graph, the loss's gradient
with respect to them, then each chunk's forward again and its backward.
Run it with TF32 off (`no_tf32`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

Op = Callable[[torch.Tensor], torch.Tensor]
PIXEL_MEAN = (0.485, 0.456, 0.406)
PIXEL_STD = (0.229, 0.224, 0.225)
ARCH_CONFIGS = {"base_patch16_224": (16, 224, 768, 12, 12)}


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def no_tf32() -> None:
    """float32 products in float32 on a card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass(frozen=True)
class Widths:
    vocab: int = 30522
    text_dim: int = 768
    text_layers: int = 6
    text_heads: int = 12
    text_hidden: int = 3072
    max_positions: int = 512
    text_eps: float = 1e-12
    dropout: float = 0.1
    attention_dropout: float = 0.1
    frames: int = 4
    resolution: int = 224
    patch: int = 16
    dim: int = 768
    depth: int = 12
    heads: int = 12
    eps: float = 1e-6
    mlp_ratio: int = 4
    proj: int = 256
    temperature: float = 0.05

    @property
    def patches(self) -> int:
        return (self.resolution // self.patch) ** 2

    @classmethod
    def from_config(cls, cfg: dict) -> "Widths":
        """The widths a program config states (Frozen's `video_params`, the
        text tower's `config`, the loss's temperature)."""
        args = cfg["arch"]["args"]
        v = args.get("video_params", {})
        patch, res, dim, depth, heads = ARCH_CONFIGS[v.get("arch_config", "base_patch16_224")]
        t = args.get("text_params", {}).get("config", {}) or {}
        return cls(vocab=int(t.get("vocab_size", 30522)), text_dim=int(t.get("dim", 768)),
                   text_layers=int(t.get("n_layers", 6)), text_heads=int(t.get("n_heads", 12)),
                   text_hidden=int(t.get("hidden_dim", 3072)),
                   max_positions=int(t.get("max_position_embeddings", 512)),
                   text_eps=float(t.get("layer_norm_eps", 1e-12)),
                   dropout=float(t.get("dropout", 0.1)),
                   attention_dropout=float(t.get("attention_dropout", 0.1)),
                   frames=int(v.get("num_frames", 4)), resolution=int(v.get("resolution", res)),
                   patch=int(v.get("patch_size", patch)), dim=int(v.get("embed_dim", dim)),
                   depth=int(v.get("depth", depth)), heads=int(v.get("heads", heads)),
                   proj=int(args.get("projection_dim", 256)),
                   temperature=float(cfg.get("loss", {}).get("args", {}).get("temperature",
                                                                              0.05)))


def param_shapes(w: Widths) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the model, by name."""
    s: Dict[str, Tuple[int, ...]] = {}

    def lin(name, n_in, n_out):
        s[f"{name}.weight"] = (n_out, n_in)
        s[f"{name}.bias"] = (n_out,)

    def norm(name, dim):
        s[f"{name}.weight"] = (dim,)
        s[f"{name}.bias"] = (dim,)

    d = w.text_dim
    s["text_model.embeddings.word_embeddings.weight"] = (w.vocab, d)
    s["text_model.embeddings.position_embeddings.weight"] = (w.max_positions, d)
    norm("text_model.embeddings.LayerNorm", d)
    for i in range(w.text_layers):
        p = f"text_model.transformer.layer.{i}"
        for n in ("q_lin", "k_lin", "v_lin", "out_lin"):
            lin(f"{p}.attention.{n}", d, d)
        norm(f"{p}.sa_layer_norm", d)
        lin(f"{p}.ffn.lin1", d, w.text_hidden)
        lin(f"{p}.ffn.lin2", w.text_hidden, d)
        norm(f"{p}.output_layer_norm", d)
    lin("txt_proj.1", d, w.proj)
    o = w.dim
    s["video_model.cls_token"] = (1, 1, o)
    s["video_model.pos_embed"] = (1, w.patches + 1, o)
    s["video_model.temporal_embed"] = (1, w.frames, o)
    lin("video_model.patch_embed.proj", 3 * w.patch * w.patch, o)
    for i in range(w.depth):
        p = f"video_model.blocks.{i}"
        for n in ("norm1", "norm2", "norm3"):
            norm(f"{p}.{n}", o)
        for a in ("attn", "timeattn"):
            lin(f"{p}.{a}.qkv", o, 3 * o)
            lin(f"{p}.{a}.proj", o, o)
        lin(f"{p}.mlp.fc1", o, w.mlp_ratio * o)
        lin(f"{p}.mlp.fc2", w.mlp_ratio * o, o)
    norm("video_model.norm", o)
    lin("vid_proj.0", o, w.proj)
    return s


def _linear(x, P, name: str, op: Op):
    return F.linear(op(x), op(P[f"{name}.weight"]), P.get(f"{name}.bias"))


def _norm(x, P, name: str, eps: float):
    return F.layer_norm(x, (x.shape[-1],), P[f"{name}.weight"], P[f"{name}.bias"], eps)


def _softmax_attend(q, k, v, op: Op, bias=None, probs_mask=None, keep: float = 1.0):
    logits = op(q) @ op(k).transpose(-1, -2)
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1)
    if probs_mask is not None:
        probs = probs * probs_mask / keep
    return op(probs) @ op(v)


def text_tower(P: Dict[str, torch.Tensor], w: Widths, input_ids, attention_mask,
               masks: Optional[Iterator[torch.Tensor]] = None, op: Op = _identity):
    """(B, proj) global text embeddings. `masks` yields the dropout
    keep-masks in the order the layers apply them (the embeddings, then
    each layer's attention probabilities and FFN output); None is eval
    mode."""
    b, length = input_ids.shape
    d, h = w.text_dim, w.text_heads
    hd = d // h

    def drop(x, p):
        return x if masks is None else x * next(masks) / (1.0 - p)

    pos = torch.arange(length, device=input_ids.device)
    x = P["text_model.embeddings.word_embeddings.weight"][input_ids]
    x = x + P["text_model.embeddings.position_embeddings.weight"][pos][None]
    x = drop(_norm(x, P, "text_model.embeddings.LayerNorm", w.text_eps), w.dropout)
    bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9).float()

    def heads(t):
        return t.reshape(b, length, h, hd).transpose(1, 2)

    for i in range(w.text_layers):
        p = f"text_model.transformer.layer.{i}"
        q = heads(_linear(x, P, f"{p}.attention.q_lin", op)) / math.sqrt(hd)
        k = heads(_linear(x, P, f"{p}.attention.k_lin", op))
        v = heads(_linear(x, P, f"{p}.attention.v_lin", op))
        pm = None if masks is None else next(masks)
        a = _softmax_attend(q, k, v, op, bias, pm, 1.0 - w.attention_dropout)
        a = a.transpose(1, 2).reshape(b, length, d)
        x = _norm(x + _linear(a, P, f"{p}.attention.out_lin", op), P, f"{p}.sa_layer_norm",
                  w.text_eps)
        f = _linear(F.gelu(_linear(x, P, f"{p}.ffn.lin1", op)), P, f"{p}.ffn.lin2", op)
        x = _norm(x + drop(f, w.dropout), P, f"{p}.output_layer_norm", w.text_eps)
    return _linear(torch.relu(x[:, 0]), P, "txt_proj.1", op)


def divided_attention(q, k, v, mode: str, frames: int, patches: int, op: Op = _identity):
    """Frozen's VarAttention on (B h, 1 + F N, hd) queries, keys and values
    (q already scaled): the CLS row over every key; every other row over
    the CLS key and its group's keys, a softmax a group."""
    bh, n1, hd = q.shape
    f, n = frames, patches
    cls_out = _softmax_attend(q[:, :1], k, v, op)
    qs, ks, vs = q[:, 1:], k[:, 1:], v[:, 1:]
    if mode == "space":  # 'b (f n) d -> (b f) n d'
        def grp(t):
            return t.reshape(bh * f, n, hd)

        def ungrp(t):
            return t.reshape(bh, f * n, hd)

        r = f
    elif mode == "time":  # 'b (f n) d -> (b n) f d'
        def grp(t):
            return t.reshape(bh, f, n, hd).transpose(1, 2).reshape(bh * n, f, hd)

        def ungrp(t):
            return t.reshape(bh, n, f, hd).transpose(1, 2).reshape(bh, f * n, hd)

        r = n
    else:
        raise ValueError(f"mode {mode!r}: expected 'space' or 'time'")
    cls_k = k[:, :1].repeat_interleave(r, dim=0)
    cls_v = v[:, :1].repeat_interleave(r, dim=0)
    out = _softmax_attend(grp(qs), torch.cat([cls_k, grp(ks)], 1),
                          torch.cat([cls_v, grp(vs)], 1), op)
    return torch.cat([cls_out, ungrp(out)], dim=1)


def _var_attention(x, P, name: str, w: Widths, mode: str, frames: int, op: Op):
    b, n1, d = x.shape
    h = w.heads
    hd = d // h
    q, k, v = _linear(x, P, f"{name}.qkv", op).chunk(3, dim=-1)
    q, k, v = (t.reshape(b, n1, h, hd).transpose(1, 2).reshape(b * h, n1, hd)
               for t in (q, k, v))
    out = divided_attention(q * hd ** -0.5, k, v, mode, frames, w.patches, op)
    out = out.reshape(b, h, n1, hd).transpose(1, 2).reshape(b, n1, d)
    return _linear(out, P, f"{name}.proj", op)


def patch_tokens(P, w: Widths, video, op: Op = _identity):
    """(B, F N, D): normalised frames through the patch embedding, as
    Frozen's Conv2d over each frame."""
    b, f, c, r, _ = video.shape
    mean = torch.tensor(PIXEL_MEAN, device=video.device).view(1, 1, 3, 1, 1)
    std = torch.tensor(PIXEL_STD, device=video.device).view(1, 1, 3, 1, 1)
    x = ((video.float() / 255.0 - mean) / std).reshape(b * f, c, r, r)
    kernel = P["video_model.patch_embed.proj.weight"].reshape(w.dim, c, w.patch, w.patch)
    y = F.conv2d(op(x), op(kernel), P["video_model.patch_embed.proj.bias"], stride=w.patch)
    return y.flatten(2).transpose(1, 2).reshape(b, f * w.patches, w.dim)


def video_tower(P: Dict[str, torch.Tensor], w: Widths, video, op: Op = _identity):
    """(B, proj) global video embeddings of uint8 frames (B, F, 3, R, R)."""
    b, f = video.shape[:2]
    n = w.patches
    x = patch_tokens(P, w, video, op)
    pos = P["video_model.pos_embed"]
    tiled = pos[:, 1:].repeat(1, f, 1) + P["video_model.temporal_embed"][:, :f].repeat_interleave(
        n, dim=1)
    x = torch.cat([P["video_model.cls_token"].expand(b, 1, w.dim) + pos[:, :1], x + tiled], 1)
    for i in range(w.depth):
        p = f"video_model.blocks.{i}"
        t = x + _var_attention(_norm(x, P, f"{p}.norm3", w.eps), P, f"{p}.timeattn", w,
                               "time", f, op)
        s = x + _var_attention(_norm(t, P, f"{p}.norm1", w.eps), P, f"{p}.attn", w, "space",
                               f, op)
        y = _norm(s, P, f"{p}.norm2", w.eps)
        x = s + _linear(F.gelu(_linear(y, P, f"{p}.mlp.fc1", op)), P, f"{p}.mlp.fc2", op)
    cls = _norm(x[:, 0], P, "video_model.norm", w.eps)
    return _linear(cls, P, "vid_proj.0", op)


def norm_softmax_loss(text: torch.Tensor, video: torch.Tensor,
                      temperature: float = 0.05) -> torch.Tensor:
    """Frozen's NormSoftmaxLoss on the cosine similarities (text rows,
    video columns), each norm floored at 1e-8."""
    t = text / torch.clamp(torch.linalg.norm(text, dim=1, keepdim=True), min=1e-8)
    v = video / torch.clamp(torch.linalg.norm(video, dim=1, keepdim=True), min=1e-8)
    sim = t @ v.T / temperature
    i = torch.log_softmax(sim, dim=1)
    j = torch.log_softmax(sim.T, dim=1)
    return -torch.mean(torch.diagonal(i)) - torch.mean(torch.diagonal(j))


def forward(P, w: Widths, batch: Dict[str, torch.Tensor], masks=None, op: Op = _identity):
    """(text (B, proj), video (B, proj), loss)."""
    t = text_tower(P, w, batch["input_ids"], batch["attention_mask"], masks, op)
    v = video_tower(P, w, batch["video"], op)
    return t, v, norm_softmax_loss(t, v, w.temperature)


def loss_and_grads(P: Dict[str, torch.Tensor], w: Widths, batch: Dict[str, torch.Tensor],
                   masks=None, op: Op = _identity, chunk: int = 0):
    """(loss, {name: gradient}) of one batch; P's tensors must require
    grad. With `chunk`, the video tower is differentiated `chunk` videos
    at a time (module docstring): the same gradient in less memory."""
    video = batch["video"]
    names = list(P)
    with torch.enable_grad():
        t = text_tower(P, w, batch["input_ids"], batch["attention_mask"], masks, op)
        if not chunk or chunk >= video.shape[0]:
            v = video_tower(P, w, video, op)
            loss = norm_softmax_loss(t, v, w.temperature)
            grads = torch.autograd.grad(loss, [P[k] for k in names], allow_unused=True)
        else:
            with torch.no_grad():
                v = torch.cat([video_tower(P, w, video[i:i + chunk], op)
                               for i in range(0, video.shape[0], chunk)])
            v.requires_grad_(True)
            loss = norm_softmax_loss(t, v, w.temperature)
            g_v, *grads = torch.autograd.grad(loss, [v] + [P[k] for k in names],
                                              allow_unused=True)
            grads = list(grads)
            for i in range(0, video.shape[0], chunk):
                part = torch.autograd.grad(video_tower(P, w, video[i:i + chunk], op),
                                           [P[k] for k in names], grad_outputs=g_v[i:i + chunk],
                                           allow_unused=True)
                grads = [a if b is None else (b if a is None else a + b)
                         for a, b in zip(grads, part)]
    out = {k: (g if g is not None else torch.zeros_like(P[k])) for k, g in zip(names, grads)}
    return loss.detach(), out
