"""Entry-point assembly for the serving CLI: config -> model, tokenizer,
eval loaders and local-score knobs (the parts of demovlp_tpu/cli/common.py
the serving path needs)."""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import torch

from demovlp_tpu_torch.convert.from_jax import load_reference_state_dict
from demovlp_tpu_torch.data.loader import MultiDistTextObjectVideoDataLoader
from demovlp_tpu_torch.data.tokenizer import build_tokenizer
from demovlp_tpu_torch.models import DistilBertConfig, ObjectRelation

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(config: Dict[str, Any]) -> torch.dtype:
    precision = config.get("precision", {}) or {}
    if precision.get("norm", "float32") != "float32":
        raise NotImplementedError("precision.norm other than float32 is not ported")
    name = precision.get("compute", "float32")
    if name not in _DTYPES:
        raise ValueError(f"precision.compute {name!r}: expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


def build_model(config: Dict[str, Any]) -> ObjectRelation:
    """The arch from its config section (ObjectRelation only), with the
    nested object_params/text_params flattened as the JAX package does."""
    arch = config["arch"]
    if arch["type"] != "ObjectRelation":
        raise NotImplementedError(f"arch {arch['type']!r} is not ported")
    args = arch.get("args", {})
    obj_p = args.get("object_params", {})
    txt_p = args.get("text_params", {})
    kwargs = dict(
        object_num=int(obj_p.get("object_num", 30)),
        num_frames=int(obj_p.get("num_frames", 4)),
        time_module=obj_p.get("time_module") or None,
        projection_dim=int(args.get("projection_dim", 256)),
        attn_impl=obj_p.get("attn_impl") or "dense",
        compute_dtype=compute_dtype(config),
    )
    for src, dst in (("embed_dim", "object_embed_dim"), ("depth", "object_depth"),
                     ("heads", "object_heads")):
        if src in obj_p:
            kwargs[dst] = int(obj_p[src])
    if txt_p.get("config"):
        kwargs["text_config"] = DistilBertConfig(**txt_p["config"])
    return ObjectRelation(**kwargs)


def build_serving_model(config: Dict[str, Any], device: torch.device,
                        weights: Optional[str] = None, seed: int = 0) -> ObjectRelation:
    """The model on `device`, in eval mode: weights from a reference-schema
    `.pth` when given (strict load), else seeded random init."""
    model = build_model(config)
    if weights:
        model.load_state_dict(load_reference_state_dict(weights), strict=True)
    else:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def build_tokenizer_from_config(config: Dict[str, Any]):
    model_path = config["arch"].get("args", {}).get("text_params", {}).get("model", "")
    return build_tokenizer(model_path)


def init_val_loaders(config: Dict[str, Any], split: str = "test") -> List:
    """Eval loaders for every data_loader section, with the split swapped
    and shuffling off."""
    section = config["data_loader"]
    loaders = []
    for sec in section if isinstance(section, list) else [section]:
        sec = copy.deepcopy(dict(sec))
        if sec["type"] != "MultiDistTextObjectVideoDataLoader":
            raise NotImplementedError(f"data loader {sec['type']!r} is not ported")
        args = sec.get("args", {})
        args["split"] = split
        args["shuffle"] = False
        loaders.append(MultiDistTextObjectVideoDataLoader(**args))
    return loaders


def local_score_args(config: Dict[str, Any]) -> Dict:
    """use_local / lambda_softmax / focal_type as the loss class reads them
    (GlobalLocalLoss defaults: use_local True, lambda 20.0, focal 'prob')."""
    loss = config.get("loss", {}) or {}
    args = loss.get("args", {}) or {}
    return {
        "use_local": loss.get("type") == "GlobalLocalLoss" and bool(args.get("use_local", True)),
        "lambda_softmax": float(args.get("lambda_softmax", 20.0)),
        "focal_type": str(args.get("focal_type", "prob")),
    }
