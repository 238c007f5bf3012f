"""Plain PyTorch reference of the ObjectRelation towers (DemoVLP, arXiv
2203.07720): a DistilBERT text tower and a region transformer with divided
space attention, as plain functions over a dict of float32 tensors keyed by
the upstream checkpoint's names. No kernel, no cache, no batching trick.

`op` rounds every product operand: identity for the float32 reference, a
lower precision for the controls (precision.py). Everything else (norms,
softmax, GELU, residuals) is float32.

Departures from a stock DistilBERT / ViT block, all as the upstream model
has them: the region input is 2048 appearance + 6 geometry features
embedded by two Linears and summed; the position embed goes on the CLS row
only, plus a temporal embed per frame; with several frames, space
attention lets a region attend to the CLS token and its own frame's regions
(the CLS token attends to all); the region tower has no final norm; masks
are additive, -100 for a padded region or word.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

Op = Callable[[torch.Tensor], torch.Tensor]
APPEARANCE = 2048
GEOMETRY = 6


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
    obj_dim: int = 768
    obj_depth: int = 12
    obj_heads: int = 12
    obj_eps: float = 1e-6
    mlp_ratio: int = 4
    regions: int = 30
    frames: int = 1
    proj: int = 256

    @classmethod
    def from_config(cls, cfg: dict) -> "Widths":
        """The widths a program config states (the published ones where a
        key is absent)."""
        args = cfg["arch"]["args"]
        obj, txt = args.get("object_params", {}), args.get("text_params", {})
        t = txt.get("config", {}) or {}
        return cls(vocab=int(t.get("vocab_size", 30522)), text_dim=int(t.get("dim", 768)),
                   text_layers=int(t.get("n_layers", 6)), text_heads=int(t.get("n_heads", 12)),
                   text_hidden=int(t.get("hidden_dim", 3072)),
                   max_positions=int(t.get("max_position_embeddings", 512)),
                   text_eps=float(t.get("layer_norm_eps", 1e-12)),
                   dropout=float(t.get("dropout", 0.1)),
                   attention_dropout=float(t.get("attention_dropout", 0.1)),
                   obj_dim=int(obj.get("embed_dim", 768)), obj_depth=int(obj.get("depth", 12)),
                   obj_heads=int(obj.get("heads", 12)), regions=int(obj.get("object_num", 30)),
                   frames=int(obj.get("num_frames", 4)),
                   proj=int(args.get("projection_dim", 256)))


def param_shapes(w: Widths) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the retrieval model, by its upstream name."""
    s: Dict[str, Tuple[int, ...]] = {}

    def lin(name, n_in, n_out, bias=True):
        s[f"{name}.weight"] = (n_out, n_in)
        if bias:
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
    o = w.obj_dim
    s["object_model.cls_token"] = (1, 1, o)
    s["object_model.custom_pos_embed"] = (1, w.regions + 1, o)
    s["object_model.temporal_embed"] = (1, w.frames, o)
    lin("object_model.object_embedding", APPEARANCE, o)
    lin("object_model.pos_embedding", GEOMETRY, o)
    for i in range(w.obj_depth):
        p = f"object_model.blocks.{i}"
        norm(f"{p}.norm1", o)
        lin(f"{p}.attn.qkv", o, 3 * o)
        lin(f"{p}.attn.proj", o, o)
        norm(f"{p}.norm2", o)
        lin(f"{p}.mlp.fc1", o, w.mlp_ratio * o)
        lin(f"{p}.mlp.fc2", w.mlp_ratio * o, o)
    lin("object_model.proj", o, w.proj, bias=False)
    return s


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _linear(x, P, name: str, op: Op):
    b = P.get(f"{name}.bias")
    return F.linear(op(x), op(P[f"{name}.weight"]), b)


def _norm(x, P, name: str, eps: float):
    return F.layer_norm(x, (x.shape[-1],), P[f"{name}.weight"], P[f"{name}.bias"], eps)


def _attend(q, k, v, bias, op: Op, probs_mask: Optional[torch.Tensor] = None,
            keep: float = 1.0):
    """softmax(q k^T + bias) v over (B, h, L, hd); dropout on the
    probabilities where `probs_mask` is given."""
    probs = torch.softmax(op(q) @ op(k).transpose(-1, -2) + bias, dim=-1)
    if probs_mask is not None:
        probs = probs * probs_mask / keep
    return op(probs) @ op(v)


def text_tower(P: Dict[str, torch.Tensor], w: Widths, input_ids, attention_mask,
               masks: Optional[Iterator[torch.Tensor]] = None, op: Op = _identity):
    """(global (B, proj), local (B, L-1, proj)) text embeddings. `masks`
    yields the dropout keep-masks in the order the layers apply them (the
    embeddings, then each layer's attention probabilities and FFN output);
    None is eval mode."""
    b, length = input_ids.shape
    d, h = w.text_dim, w.text_heads
    hd = d // h
    keep_h = 1.0 - w.dropout
    keep_a = 1.0 - w.attention_dropout

    def drop(x, keep):
        return x if masks is None else x * next(masks) / keep

    pos = torch.arange(length, device=input_ids.device)
    x = P["text_model.embeddings.word_embeddings.weight"][input_ids]
    x = x + P["text_model.embeddings.position_embeddings.weight"][pos][None]
    x = drop(_norm(x, P, "text_model.embeddings.LayerNorm", w.text_eps), keep_h)
    bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9).float()

    def heads(t):
        return t.reshape(b, length, h, hd).transpose(1, 2)

    for i in range(w.text_layers):
        p = f"text_model.transformer.layer.{i}"
        q = heads(_linear(x, P, f"{p}.attention.q_lin", op)) / math.sqrt(hd)
        k = heads(_linear(x, P, f"{p}.attention.k_lin", op))
        v = heads(_linear(x, P, f"{p}.attention.v_lin", op))
        pm = None if masks is None else next(masks)
        a = _attend(q, k, v, bias, op, pm, keep_a).transpose(1, 2).reshape(b, length, d)
        x = _norm(x + _linear(a, P, f"{p}.attention.out_lin", op), P, f"{p}.sa_layer_norm",
                  w.text_eps)
        f = _linear(F.gelu(_linear(x, P, f"{p}.ffn.lin1", op)), P, f"{p}.ffn.lin2", op)
        x = _norm(x + drop(f, keep_h), P, f"{p}.output_layer_norm", w.text_eps)
    t = _linear(torch.relu(x), P, "txt_proj.1", op)
    return t[:, 0], t[:, 1:]


def dropout_shapes(w: Widths, batch: int, length: int):
    """(shape, which) of each dropout mask of one text-tower forward, in
    order: "h" a hidden-state mask, "a" an attention-probability mask."""
    out = [((batch, length, w.text_dim), "h")]
    for _ in range(w.text_layers):
        out += [((batch, w.text_heads, length, length), "a"), ((batch, length, w.text_dim), "h")]
    return out


def _space_bias(frames: int, regions: int, device) -> torch.Tensor:
    """(1+F*K, 1+F*K) additive bias of space attention: a region sees the
    CLS token and the regions of its own frame; the CLS token sees all."""
    n = frames * regions
    frame = torch.arange(n, device=device) // regions
    ok = torch.ones((1 + n, 1 + n), dtype=torch.bool, device=device)
    ok[1:, 1:] = frame[:, None] == frame[None, :]
    return torch.where(ok, 0.0, -1e9)


def object_tower(P: Dict[str, torch.Tensor], w: Widths, feats, feat_mask, op: Op = _identity):
    """(global (B, proj), local (B, F*K, proj), additive region mask
    (B, F*K)). feats (B, F, K, 2054), feat_mask (B, F, K) 1 / 0."""
    b, f, k, _ = feats.shape
    d, h = w.obj_dim, w.obj_heads
    hd = d // h
    feats = feats.float()
    tok = _linear(feats[..., :APPEARANCE], P, "object_model.object_embedding", op)
    tok = tok + _linear(feats[..., APPEARANCE:], P, "object_model.pos_embedding", op)
    x = torch.cat([P["object_model.cls_token"].expand(b, 1, d), tok.reshape(b, f * k, d)], 1)
    valid = torch.cat([torch.ones((b, 1), device=feats.device),
                       feat_mask.reshape(b, f * k).float()], 1)
    add = (valid - 1.0) * 100.0
    pos = torch.cat([P["object_model.custom_pos_embed"][:, :1],
                     P["object_model.temporal_embed"][:, :f].repeat_interleave(k, dim=1)], 1)
    x = x + pos
    n1 = 1 + f * k
    bias = add[:, None, None, :]
    if f > 1:
        bias = bias + _space_bias(f, k, feats.device)
    for i in range(w.obj_depth):
        p = f"object_model.blocks.{i}"
        y = _norm(x, P, f"{p}.norm1", w.obj_eps)
        qkv = _linear(y, P, f"{p}.attn.qkv", op).reshape(b, n1, 3, h, hd).permute(2, 0, 3, 1, 4)
        a = _attend(qkv[0] * hd ** -0.5, qkv[1], qkv[2], bias, op)
        x = x + _linear(a.transpose(1, 2).reshape(b, n1, d), P, f"{p}.attn.proj", op)
        y = _norm(x, P, f"{p}.norm2", w.obj_eps)
        x = x + _linear(F.gelu(_linear(y, P, f"{p}.mlp.fc1", op)), P, f"{p}.mlp.fc2", op)
    o = _linear(x, P, "object_model.proj", op)
    return o[:, 0], o[:, 1:], add[:, 1:]
