"""Entry-point assembly: config -> model, tokenizer, loaders, loss, metrics,
optimizer and local-score knobs (counterpart of demovlp_tpu/cli/common.py).
A plain name -> constructor table stands in for the JAX package's registry."""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple

import torch

from demovlp_tpu_torch.convert.from_jax import load_reference_state_dict
from demovlp_tpu_torch.data.loader import MultiDistTextObjectVideoDataLoader
from demovlp_tpu_torch.data.tokenizer import build_tokenizer
from demovlp_tpu_torch.losses.losses import GlobalLocalLoss, NormSoftmaxLoss, RWALoss
from demovlp_tpu_torch.metrics.retrieval import METRICS
from demovlp_tpu_torch.models import DistilBertConfig, ObjectRelation
from demovlp_tpu_torch.train.optim import AdamW

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


def build_train_model(config: Dict[str, Any], device: torch.device,
                      seed: int = 0) -> ObjectRelation:
    """The model on `device`: seeded random init, then the weights of
    `arch.args.load_checkpoint` when it names a reference-schema `.pth`
    (strict; the temporal-embed inflation of the JAX loader is not ported)."""
    model = build_model(config)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    ckpt = config["arch"].get("args", {}).get("load_checkpoint", "")
    if ckpt:
        model.load_state_dict(load_reference_state_dict(ckpt), strict=True)
    return model.to(device)


_LOSSES = {cls.__name__: cls for cls in (GlobalLocalLoss, NormSoftmaxLoss, RWALoss)}


def build_loss(config: Dict[str, Any]):
    section = config["loss"]
    if section["type"] not in _LOSSES:
        raise NotImplementedError(f"loss {section['type']!r} is not ported")
    return _LOSSES[section["type"]](**section.get("args", {}))


def build_metrics(config: Dict[str, Any]) -> List:
    missing = [m for m in config["metrics"] if m not in METRICS]
    if missing:
        raise NotImplementedError(f"metrics {missing} are not ported")
    return [METRICS[name] for name in config["metrics"]]


def build_optimizer(config: Dict[str, Any], params) -> AdamW:
    section = config["optimizer"]
    if section["type"] != "AdamW":
        raise NotImplementedError(f"optimizer {section['type']!r} is not ported")
    args = dict(section.get("args", {}))
    return AdamW(params, lr=float(args.pop("lr", 1e-5)), **args)


def build_tokenizer_from_config(config: Dict[str, Any]):
    model_path = config["arch"].get("args", {}).get("text_params", {}).get("model", "")
    return build_tokenizer(model_path)


def _loader(sec: Dict[str, Any], **override) -> MultiDistTextObjectVideoDataLoader:
    if sec["type"] != "MultiDistTextObjectVideoDataLoader":
        raise NotImplementedError(f"data loader {sec['type']!r} is not ported")
    return MultiDistTextObjectVideoDataLoader(**{**sec.get("args", {}), **override})


def init_dataloaders(config: Dict[str, Any], val_split: str = "val",
                     train: bool = True) -> Tuple[List, List]:
    """Train loaders from the config (one section or a list), and val
    loaders with the reference's swap rules: split -> `val_split`, no
    shuffling, CC3M subsampled to 1%, LSMDC multiple choice on split 'val'
    with batch 1. train=False builds no train loader."""
    section = config["data_loader"]
    sections = section if isinstance(section, list) else [section]
    train_loaders = [_loader(sec) for sec in sections] if train else []
    val_loaders = []
    for sec in sections:
        override = {"split": val_split, "shuffle": False}
        name = sec.get("args", {}).get("dataset_name", "")
        if name == "ConceptualCaptions3MObjectSelect":
            override["subsample"] = 0.01
        if name == "LSMDCMCObjectSelect":
            override.update(split="val", batch_size=1)
        val_loaders.append(_loader(copy.deepcopy(dict(sec)), **override))
    return train_loaders, val_loaders


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
