"""Video-QA prediction from a checkpoint (counterpart of
scripts/predict_qa.py).

    python -m demovlp_tpu_torch.cli.predict_qa -c configs/ft/msrvtt_qa-select.json \\
        [-r weights.pth] [--split test] [--output predictions.json] [--device cpu]

Runs the QA eval step over every loader of the config's dataset split and
writes one {question_id, answer, answer_text} entry a question, every
question once; `answer_text` comes from the dataset's `label2ans`. A bf16
model gets its region tensor cast to bf16 on the host. `-r` takes a
reference-schema `.pth` (the QA trainer's checkpoint is one); without it
the weights are seeded random init (--seed). Runs on the card unless
`--device cpu` is given; with no card it raises.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import torch

from demovlp_tpu_torch import serve
from demovlp_tpu_torch.cli.common import (build_serving_model, build_tokenizer_from_config,
                                          compute_dtype, init_dataloaders)
from demovlp_tpu_torch.config import build_argparser, read_config
from demovlp_tpu_torch.device import resolve_device
from demovlp_tpu_torch.train.steps import make_qa_eval_step


def _parser():
    p = build_argparser("video-QA prediction (PyTorch port)")
    p.add_argument("--split", default="test", help="dataset split")
    p.add_argument("--output", default="predictions.json", help="JSON path for the predictions")
    return p


def run(argv: Optional[Sequence[str]] = None) -> List[Dict[str, Any]]:
    """Run the CLI; returns one record per loader: {results, path, seconds}."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    config = read_config(args.config)
    model = build_serving_model(config, device, args.resume, args.seed)
    tokenizer = build_tokenizer_from_config(config)
    loaders = init_dataloaders(config, val_split=args.split, train=False)[1]
    transfer = torch.bfloat16 if compute_dtype(config) == torch.bfloat16 else None
    eval_step = make_qa_eval_step(model)
    out_path = Path(args.output)
    records = []
    for i, dl in enumerate(loaders):
        t0 = time.perf_counter()
        results = serve.predict_qa(eval_step, dl, tokenizer, device,
                                   label2ans=getattr(dl.dataset, "label2ans", None),
                                   transfer_dtype=transfer)
        seconds = time.perf_counter() - t0
        path = out_path if len(loaders) == 1 else out_path.with_stem(f"{out_path.stem}_{i}")
        path.write_text(json.dumps(results, indent=1))
        print(f"[predict_qa] wrote {len(results)} predictions -> {path} in {seconds:.3f}s "
              f"({len(results) / seconds:.1f} questions/s)")
        records.append({"results": results, "path": path, "seconds": seconds})
    return records


if __name__ == "__main__":
    run()
