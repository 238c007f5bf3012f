"""Weights carried across: the JAX package's parameter tree -> the port's
state_dict (the port's own copy of the mapping in
demovlp_tpu/convert/torch_export.py).

Conventions: flax Dense kernel (in, out) -> Linear weight (out, in);
LayerNorm {scale, bias} (under LayerNorm_0) -> {weight, bias}; embedding
tables as they are; WeightNormDense {g, v, bias} -> {weight_g (a 0-d
scalar), weight_v (out, in), bias}, with FCNet layer i at `main.{2 i}`. Key names are the reference torch schema, which the
port's modules use, so `load_state_dict(strict=True)` needs no renaming.
The MLM head, which the reference schema lacks, takes Hugging Face
DistilBertForMaskedLM's names under `mlm_head.` (its flax LayerNorm holds
{scale, bias} directly).

The reference creates two families of parameters it never applies: the
final `object_model.norm` LayerNorm and each block's `norm3` when there is
no time module. The port does not create them, so `from_jax` never emits
them and `load_reference_state_dict` drops them from a reference `.pth`.

`extractor_from_jax` carries a flax PatchRegionExtractor's params over to
the port's module, whose keys follow the flax names.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _np(x) -> np.ndarray:
    a = np.asarray(x)
    if a.dtype != np.float32:
        a = a.astype(np.float32)
    return np.ascontiguousarray(a)


def _dense(out: Dict, tree: Mapping, key: str) -> None:
    out[f"{key}.weight"] = np.ascontiguousarray(_np(tree["kernel"]).T)
    if "bias" in tree:
        out[f"{key}.bias"] = _np(tree["bias"])


def _ln(out: Dict, tree: Mapping, key: str) -> None:
    ln = tree["LayerNorm_0"]
    out[f"{key}.weight"] = _np(ln["scale"])
    out[f"{key}.bias"] = _np(ln["bias"])


def _distilbert(out: Dict, tree: Mapping, p: str) -> None:
    out[f"{p}embeddings.word_embeddings.weight"] = _np(tree["word_embeddings"]["embedding"])
    out[f"{p}embeddings.position_embeddings.weight"] = _np(
        tree["position_embeddings"]["embedding"]
    )
    _ln(out, tree["emb_layer_norm"], f"{p}embeddings.LayerNorm")
    i = 0
    while f"layer_{i}" in tree:
        layer = tree[f"layer_{i}"]
        lp = f"{p}transformer.layer.{i}."
        for name in ("q_lin", "k_lin", "v_lin", "out_lin"):
            _dense(out, layer["attention"][name], f"{lp}attention.{name}")
        _ln(out, layer["sa_layer_norm"], f"{lp}sa_layer_norm")
        _dense(out, layer["ffn_lin1"], f"{lp}ffn.lin1")
        _dense(out, layer["ffn_lin2"], f"{lp}ffn.lin2")
        _ln(out, layer["output_layer_norm"], f"{lp}output_layer_norm")
        i += 1


def _object_tower(out: Dict, tree: Mapping, p: str) -> None:
    for name in ("cls_token", "custom_pos_embed", "temporal_embed"):
        out[f"{p}{name}"] = _np(tree[name])
    _dense(out, tree["object_embedding"], f"{p}object_embedding")
    _dense(out, tree["pos_embedding"], f"{p}pos_embedding")
    _dense(out, tree["proj"], f"{p}proj")
    i = 0
    while f"blocks_{i}" in tree:
        blk = tree[f"blocks_{i}"]
        bp = f"{p}blocks.{i}."
        _ln(out, blk["norm1"], f"{bp}norm1")
        _ln(out, blk["norm2"], f"{bp}norm2")
        for name in ("qkv", "proj"):
            _dense(out, blk["attn"][name], f"{bp}attn.{name}")
        _dense(out, blk["mlp"]["fc1"], f"{bp}mlp.fc1")
        _dense(out, blk["mlp"]["fc2"], f"{bp}mlp.fc2")
        if "timeattn" in blk:
            _ln(out, blk["norm3"], f"{bp}norm3")
            for name in ("qkv", "proj"):
                _dense(out, blk["timeattn"][name], f"{bp}timeattn.{name}")
        i += 1


def _wn_dense(out: Dict, tree: Mapping, key: str) -> None:
    out[f"{key}.weight_g"] = _np(tree["g"]).reshape(())
    out[f"{key}.weight_v"] = np.ascontiguousarray(_np(tree["v"]).T)
    if "bias" in tree:
        out[f"{key}.bias"] = _np(tree["bias"])


def _fcnet(out: Dict, tree: Mapping, key: str) -> None:
    for name, sub in tree.items():
        _wn_dense(out, sub, f"{key}.main.{2 * int(name[len('layer'):])}")


def _qa_head(out: Dict, tree: Mapping, p: str) -> None:
    att, cls = tree["v_att"], tree["classifier"]
    _fcnet(out, att["v_proj"], f"{p}v_att.v_proj")
    _fcnet(out, att["q_proj"], f"{p}v_att.q_proj")
    _wn_dense(out, att["linear"], f"{p}v_att.linear")
    _fcnet(out, cls["q_net"], f"{p}classifier.q_net")
    _fcnet(out, cls["v_net"], f"{p}classifier.v_net")
    _dense(out, cls["main1"], f"{p}classifier.main.0")
    _dense(out, cls["main2"], f"{p}classifier.main.3")


def from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ObjectRelation / ObjectQARelation / ObjectMCRelation params
    ({'params': {...}} of numpy arrays) -> the port's state_dict of float32
    CPU tensors."""
    tree = params.get("params", params)
    out: Dict[str, np.ndarray] = {}
    text = tree["text_tower"]
    _distilbert(out, text["text_model"], "text_model.")
    _dense(out, text["txt_proj"], "txt_proj.1")
    _object_tower(out, tree["object_model"], "object_model.")
    if "head" in tree:
        _qa_head(out, tree["head"], "head.")
    if "mlm_head" in tree:
        mlm = tree["mlm_head"]
        _dense(out, mlm["vocab_transform"], "mlm_head.vocab_transform")
        out["mlm_head.vocab_layer_norm.weight"] = _np(mlm["vocab_layer_norm"]["scale"])
        out["mlm_head.vocab_layer_norm.bias"] = _np(mlm["vocab_layer_norm"]["bias"])
        _dense(out, mlm["vocab_projector"], "mlm_head.vocab_projector")
    return {k: torch.tensor(v) for k, v in out.items()}


def _flax_ln(out: Dict, tree: Mapping, key: str) -> None:
    out[f"{key}.weight"] = _np(tree["scale"])
    out[f"{key}.bias"] = _np(tree["bias"])


def extractor_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax PatchRegionExtractor params -> the port's PatchRegionExtractor
    state_dict: the stem's HWIO kernel (p, p, 3, D) -> (D, 3, p, p); each
    attention projection's DenseGeneral kernel, (D, H, hd) for query, key
    and value and (H, hd, D) for out, -> a (D, D) Linear weight over the
    flattened (H, hd) axis, with its (H, hd) bias flattened."""
    tree = params.get("params", params)
    out: Dict[str, np.ndarray] = {
        "stem.weight": np.ascontiguousarray(_np(tree["stem"]["kernel"]).transpose(3, 2, 0, 1)),
        "stem.bias": _np(tree["stem"]["bias"]),
        "pos_embed": _np(tree["pos_embed"]),
        "saliency_query": _np(tree["saliency_query"]),
    }
    i = 0
    while f"block_{i}" in tree:
        blk, bp = tree[f"block_{i}"], f"block_{i}."
        _flax_ln(out, blk["norm1"], f"{bp}norm1")
        _flax_ln(out, blk["norm2"], f"{bp}norm2")
        for name in ("query", "key", "value"):
            kernel = _np(blk["attn"][name]["kernel"])  # (D, H, hd)
            out[f"{bp}attn.{name}.weight"] = np.ascontiguousarray(
                kernel.reshape(kernel.shape[0], -1).T)
            out[f"{bp}attn.{name}.bias"] = _np(blk["attn"][name]["bias"]).reshape(-1)
        kernel = _np(blk["attn"]["out"]["kernel"])  # (H, hd, D)
        out[f"{bp}attn.out.weight"] = np.ascontiguousarray(kernel.reshape(-1, kernel.shape[-1]).T)
        out[f"{bp}attn.out.bias"] = _np(blk["attn"]["out"]["bias"])
        _dense(out, blk["mlp"]["fc1"], f"{bp}mlp.fc1")
        _dense(out, blk["mlp"]["fc2"], f"{bp}mlp.fc2")
        i += 1
    _flax_ln(out, tree["norm"], "norm")
    _dense(out, tree["appearance_proj"], "appearance_proj")
    return {k: torch.tensor(v) for k, v in out.items()}


_NORM3 = re.compile(r"^object_model\.blocks\.(\d+)\.norm3\.")


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """State dict from a reference-schema `.pth` (a bare state dict or the
    reference trainer's {'state_dict': ...} checkpoint), with any
    DataParallel `module.` prefix stripped and the never-applied
    `object_model.norm.*` / time-module-less `norm3.*` keys dropped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    has_time = {
        m.group(1) for k in sd
        if (m := re.match(r"^object_model\.blocks\.(\d+)\.timeattn\.", k))
    }
    out = {}
    for k, v in sd.items():
        if k.startswith("object_model.norm."):
            continue
        m = _NORM3.match(k)
        if m and m.group(1) not in has_time:
            continue
        out[k] = v.float()
    return out
