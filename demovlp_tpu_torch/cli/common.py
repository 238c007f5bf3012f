"""Entry-point assembly: config -> process group and mesh, model,
tokenizer, loaders, loss, metrics, optimizer, local-score knobs, the
scalar writer and the retrieval visualizer (counterpart of
demovlp_tpu/cli/common.py). A plain name -> constructor table stands in
for the JAX package's registry.

Every CLI runs one process per card under torchrun
(`torchrun --nproc-per-node N -m demovlp_tpu_torch.cli.train -c <cfg>`):
`setup_parallel` joins the process group (nccl on the card, gloo with
`--device cpu`) and builds the (data, model) mesh from `mesh.model`, which
must divide the world size; at one process there is no group and no
mesh.

`ops.xattn_backend` (else DEMOVLP_XATTN_BACKEND, else "xla") names the
JAX package's route for the local similarity and is checked against JAX
`set_backend`'s values; on the card the port's route is the kernels
(ops/xattn_kernel.py) whatever it names. With "xla" and
`loss.args.local_dtype: "bfloat16"` the log says once that the port
computes the Pallas path's bf16 numerics, not the XLA path's bf16 pipeline.

The train CLIs seed nothing global once a process: each train step seeds
torch's generators for its forward by (seed, optimizer step, data rank)
and restores them after (train/steps.py), so a resumed run draws the
dropout masks the uninterrupted run drew."""
from __future__ import annotations

import copy
import logging
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from demovlp_tpu_torch.config import (apply_overrides, build_train_argparser,
                                      make_run_dir, read_config, run_log_dir, run_stamp,
                                      run_web_dir)
from demovlp_tpu_torch.convert.from_jax import load_reference_state_dict
from demovlp_tpu_torch.convert.torch_import import load_pretrained
from demovlp_tpu_torch.data.loader import MultiDistTextObjectVideoDataLoader
from demovlp_tpu_torch.data.tokenizer import build_tokenizer
from demovlp_tpu_torch.device import resolve_device
from demovlp_tpu_torch.losses.losses import (CrossEntropy, GlobalLocalLoss,
                                             MaxMarginRankingLoss, NormSoftmaxLoss, RWALoss)
from demovlp_tpu_torch.metrics import qa as qa_metrics
from demovlp_tpu_torch.metrics import retrieval as retrieval_metrics
from demovlp_tpu_torch.models import (DistilBertConfig, ObjectMCRelation, ObjectQARelation,
                                      ObjectRelation)
from demovlp_tpu_torch.ops.xattn_kernel import check_backend
from demovlp_tpu_torch.parallel.mesh import (create_mesh, data_coords, host_allgather_pylist,
                                             is_main_process, process_count,
                                             setup_distributed)
from demovlp_tpu_torch.parallel.tp import apply_tp
from demovlp_tpu_torch.train.optim import AdamW
from demovlp_tpu_torch.train.steps import parse_text_buckets
from demovlp_tpu_torch.utils.visualizer import RetrievalVis
from demovlp_tpu_torch.utils.writer import MetricsWriter

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
logger = logging.getLogger(__name__)


def mesh_model(config: Dict[str, Any]) -> int:
    """`mesh.model`, checked: `optimizer.args.pack_small` is a
    data-parallel knob and is refused with tensor parallelism, as JAX
    cli/common.py:127-139 refuses it."""
    model = int((config.get("mesh", {}) or {}).get("model", 1))
    if model > 1 and (config.get("optimizer", {}).get("args", {}) or {}).get("pack_small"):
        raise ValueError("optimizer.args.pack_small is a data-parallel knob and is not "
                         "supported with tensor parallelism (mesh.model > 1); remove one.")
    return model


def setup_parallel(device_arg, config: Dict[str, Any]):
    """(device, mesh) of this process: the local rank's card (or the CPU
    when asked), the process group joined with nccl (gloo on the CPU), and
    the (data, model) mesh from `mesh.model`, or None at one process.
    `mesh.model` must divide the world size (JAX parallel/mesh.py:69-71)."""
    device = resolve_device(device_arg)
    model = mesh_model(config)
    xattn_backend(config)
    setup_distributed("gloo" if device.type == "cpu" else "nccl")
    world = process_count()
    if model < 1 or world % model:
        raise ValueError(f"mesh.model={model} does not divide the world size {world}")
    return device, (create_mesh(model, device.type) if world > 1 else None)


def xattn_backend(config: Dict[str, Any]) -> str:
    """The JAX package's local-similarity route for this config:
    `ops.xattn_backend`, else DEMOVLP_XATTN_BACKEND, else "xla" (JAX
    cli/common.py:41-45, ops/xattn.py:40), each checked where it is set."""
    env = os.environ.get("DEMOVLP_XATTN_BACKEND")
    if env is not None:
        check_backend("DEMOVLP_XATTN_BACKEND", env)
    name = (config.get("ops", {}) or {}).get("xattn_backend")
    if name:
        check_backend("ops.xattn_backend", name)
    backend = name or env or "xla"
    local_dtype = ((config.get("loss", {}) or {}).get("args", {}) or {}).get("local_dtype")
    if backend == "xla" and local_dtype == "bfloat16":
        logger.info("xattn backend 'xla' with local_dtype bfloat16: the port computes the "
                    "Pallas path's bf16 numerics (bf16 product operands, f32 elsewhere), "
                    "not the XLA path's bf16 pipeline")
    return backend


def _precision(config: Dict[str, Any], key: str) -> torch.dtype:
    name = (config.get("precision", {}) or {}).get(key, "float32")
    if name not in _DTYPES:
        raise ValueError(f"precision.{key} {name!r}: expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


def compute_dtype(config: Dict[str, Any]) -> torch.dtype:
    """`precision.compute`: the towers' product dtype."""
    return _precision(config, "compute")


def norm_dtype(config: Dict[str, Any]) -> torch.dtype:
    """`precision.norm`: the towers' LayerNorm compute dtype (models/layers.py)."""
    return _precision(config, "norm")


_ARCHS = {cls.__name__: cls for cls in (ObjectRelation, ObjectQARelation, ObjectMCRelation)}


def build_model(config: Dict[str, Any]) -> ObjectRelation:
    """The arch from its config section, with the nested
    object_params/text_params flattened as the JAX package does;
    `num_label` and `head_dropout` go to the QA arch only. `mlm.weight` > 0
    adds the MLM head (retrieval archs); the top-level `remat` recomputes
    the region tower's blocks in the backward."""
    arch = config["arch"]
    if arch["type"] not in _ARCHS:
        raise NotImplementedError(f"arch {arch['type']!r} is not ported")
    args = arch.get("args", {})
    obj_p = args.get("object_params", {})
    txt_p = args.get("text_params", {})
    if obj_p.get("attn_impl") == "pallas":
        # the JAX package retired this value; its kernel is an op
        # (ops/attention_kernel.py), not a model option
        raise ValueError(
            "object_params.attn_impl='pallas' was removed; the kernel "
            "remains a test-only artifact (ops/pallas_attention.py). "
            "Use 'dense' (default) or 'xla'."
        )
    kwargs = dict(
        object_num=int(obj_p.get("object_num", 30)),
        num_frames=int(obj_p.get("num_frames", 4)),
        time_module=obj_p.get("time_module") or None,
        projection_dim=int(args.get("projection_dim", 256)),
        attn_impl=obj_p.get("attn_impl") or "dense",
        compute_dtype=compute_dtype(config),
        norm_dtype=norm_dtype(config),
    )
    for src, dst in (("embed_dim", "object_embed_dim"), ("depth", "object_depth"),
                     ("heads", "object_heads")):
        if src in obj_p:
            kwargs[dst] = int(obj_p[src])
    if txt_p.get("config"):
        kwargs["text_config"] = DistilBertConfig(**txt_p["config"])
    if config.get("remat"):
        kwargs["remat"] = True
    if arch["type"] == "ObjectQARelation":
        for key, cast in (("num_label", int), ("head_dropout", float)):
            if key in obj_p:
                kwargs[key] = cast(obj_p[key])
    if float((config.get("mlm", {}) or {}).get("weight", 0.0)) > 0:
        if arch["type"] == "ObjectQARelation":
            raise ValueError("mlm.weight > 0 needs a retrieval arch; the QA arch has no MLM head")
        kwargs["with_mlm"] = True
    return _ARCHS[arch["type"]](**kwargs)


def build_serving_model(config: Dict[str, Any], device: torch.device,
                        weights: Optional[str] = None, seed: int = 0,
                        mesh=None) -> ObjectRelation:
    """The model on `device`, in eval mode: weights from a reference-schema
    `.pth` when given (strict load), else seeded random init; split over
    the mesh's model axis where it has more than one rank."""
    model = build_model(config)
    if weights:
        model.load_state_dict(load_reference_state_dict(weights), strict=True)
    else:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    return apply_tp(model.to(device), mesh).eval()


def build_train_model(config: Dict[str, Any], device: torch.device,
                      seed: int = 0, mesh=None) -> ObjectRelation:
    """The model on `device`: seeded random init, then the weights of
    `arch.args.load_checkpoint` when it names a reference-schema `.pth`,
    its temporal embed resized to `object_params.num_frames` per
    `arch.args.load_temporal_fix` (default "zeros"), loaded strictly
    (convert/torch_import.py); then split over the mesh's model axis
    (parallel/tp.py) where it has more than one rank."""
    model = build_model(config)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    args = config["arch"].get("args", {})
    ckpt = args.get("load_checkpoint", "")
    if ckpt:
        load_pretrained(model, ckpt, int(args.get("object_params", {}).get("num_frames", 4)),
                        args.get("load_temporal_fix"))
    return apply_tp(model.to(device), mesh)


_LOSSES = {cls.__name__: cls for cls in (GlobalLocalLoss, NormSoftmaxLoss, RWALoss,
                                         CrossEntropy, MaxMarginRankingLoss)}
_METRICS = {**retrieval_metrics.METRICS, **qa_metrics.METRICS}


def build_loss(config: Dict[str, Any]):
    section = config["loss"]
    if section["type"] not in _LOSSES:
        raise NotImplementedError(f"loss {section['type']!r} is not ported")
    return _LOSSES[section["type"]](**section.get("args", {}))


def build_metrics(config: Dict[str, Any]) -> List:
    missing = [m for m in config["metrics"] if m not in _METRICS]
    if missing:
        raise NotImplementedError(f"metrics {missing} are not ported")
    return [_METRICS[name] for name in config["metrics"]]


def build_optimizer(config: Dict[str, Any], params) -> AdamW:
    mesh_model(config)
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
                     train: bool = True, mesh=None) -> Tuple[List, List]:
    """Train loaders from the config (one section or a list), and val
    loaders with the reference's swap rules: split -> `val_split`, no
    shuffling, CC3M subsampled to 1%, LSMDC multiple choice on split 'val'
    with batch 1. Train loaders group lengths (where `length_grouped` is
    set) by the trainer's `text_buckets`. train=False builds no train
    loader. Each loader reads the shard of this process's data rank."""
    section = config["data_loader"]
    sections = section if isinstance(section, list) else [section]
    buckets = parse_text_buckets(config.get("trainer", {}))
    rank, ranks = data_coords(mesh)
    shard = {"process_index": rank, "process_count": ranks}
    train_loaders = ([_loader(sec, text_buckets=buckets, **shard) for sec in sections]
                     if train else [])
    val_loaders = []
    for sec in sections:
        override = {"split": val_split, "shuffle": False, **shard}
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


_VISUALIZERS = {"RetrievalVis": RetrievalVis}


def build_visualizer(config: Dict[str, Any], web_dir) -> Optional[RetrievalVis]:
    """The `visualizer` section's class writing into `web_dir`, or None
    when its type is empty (every config under configs/ today)."""
    section = config.get("visualizer", {}) or {}
    name = section.get("type")
    if not name:
        return None
    if name not in _VISUALIZERS:
        raise NotImplementedError(f"visualizer {name!r} is not ported")
    return _VISUALIZERS[name](exp_name=config["name"], web_dir=str(web_dir),
                              **section.get("args", {}))


def run_trainer(trainer_cls, description: str, val_split: str,
                argv: Optional[Sequence[str]] = None, fence_steps: bool = False):
    """A train CLI: parse the command line, build everything from the
    config and run `trainer_cls` (RetrievalTrainer, QATrainer or MCTrainer).
    The run's scalars go to `<save_dir>/log/<name>/<stamp>/scalars.jsonl`
    (closed when the run ends), its log to info.log beside them. The last
    asynchronous checkpoint write is waited for before it returns, also
    when training raised. Returns the trainer with its `final_log`."""
    args = build_train_argparser(description).parse_args(argv)
    config = apply_overrides(read_config(args.config), args)
    device, mesh = setup_parallel(args.device, config)
    cfg_trainer = config["trainer"]
    main = is_main_process()
    # one stamp for the run: rank 0's
    stamp = host_allgather_pylist([run_stamp()])[0] if process_count() > 1 else run_stamp()
    save_dir = make_run_dir(config, stamp, main)
    train_loaders, val_loaders = init_dataloaders(config, val_split=val_split, mesh=mesh)
    model = build_train_model(config, device, seed=args.seed, mesh=mesh)
    bf16 = compute_dtype(config) == torch.bfloat16
    trainer = trainer_cls(
        model, build_loss(config), build_metrics(config),
        build_optimizer(config, model.parameters()), config, save_dir, device,
        data_loader=train_loaders, valid_data_loader=val_loaders,
        tokenizer=build_tokenizer_from_config(config),
        max_samples_per_epoch=cfg_trainer.get("max_samples_per_epoch", 50000),
        transfer_dtype=torch.bfloat16 if bf16 else None, fence_steps=fence_steps,
        schedule=args.schedule, learning_rate1=args.learning_rate1,
        lr_mode=cfg_trainer.get("lr_mode", "reference"), rng_seed=args.seed,
        writer=MetricsWriter(run_log_dir(save_dir)) if main else None,
        visualizer=build_visualizer(config, run_web_dir(save_dir)) if main else None,
        mesh=mesh,
    )
    try:
        resume = args.resume or cfg_trainer.get("resume")
        if resume == "auto":
            resume = trainer.checkpoint.latest(cfg_trainer.get("save_dir", "exps"), config["name"])
        if resume:
            trainer.resume(resume)
        trainer.final_log = trainer.train()
    finally:
        try:
            trainer.checkpoint.wait()
        finally:
            if trainer.writer is not None:
                trainer.writer.close()
    return trainer
