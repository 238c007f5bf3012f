"""Extract embeddings / build a retrieval index (counterpart of
scripts/extract_embeddings.py).

    python -m demovlp_tpu_torch.cli.extract_embeddings \\
        -c configs/bench/serve_synthetic_1k.json [-r weights.pth] \\
        --split test --output emb.npz --topk 10 --results r.json [--device cpu]

Embeds every sample of the config's dataset split once, writes the npz,
and with --topk scores the full global + local similarity matrix and
writes per-caption top-k results. `-r` takes a reference-schema `.pth`
(for example one written by scripts/export_checkpoint.py); without it the
weights are seeded random init (--seed). Runs on the card unless
`--device cpu` is given; with no card it raises.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from demovlp_tpu_torch import serve
from demovlp_tpu_torch.cli.common import (build_serving_model,
                                          build_tokenizer_from_config,
                                          compute_dtype, init_val_loaders,
                                          local_score_args)
from demovlp_tpu_torch.config import build_argparser, read_config
from demovlp_tpu_torch.device import resolve_device


def _parser():
    p = build_argparser("extract embeddings and top-k retrieval (PyTorch port)")
    p.add_argument("--split", default="test", help="dataset split")
    p.add_argument("--output", default="embeddings.npz",
                   help="npz path for the gathered embeddings")
    p.add_argument("--topk", type=int, default=0,
                   help="also score sims and keep top-k per caption")
    p.add_argument("--results", default="", help="JSON path for the top-k results")
    return p


def run(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    """Run the CLI; returns one record per loader: {cat, meta, sims,
    results, embed_s, sims_s} (sims/results None without --topk)."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    config = read_config(args.config)
    model = build_serving_model(config, device, args.resume, args.seed)
    tokenizer = build_tokenizer_from_config(config)
    loaders = init_val_loaders(config, split=args.split)
    score = local_score_args(config)
    mscoco_dedup = str(config["name"]).startswith("MSCOCO")
    bf16 = compute_dtype(config) == torch.bfloat16
    embed_step = serve.make_embed_step(model)
    out_path = Path(args.output)
    records = []
    for i, dl in enumerate(loaders):
        t0 = time.perf_counter()
        cat, meta = serve.embed_loader(
            embed_step, dl, tokenizer, device,
            transfer_dtype=torch.bfloat16 if bf16 else None,
        )
        embed_s = time.perf_counter() - t0
        n = int(cat["g_t"].shape[0])
        print(f"[extract] embedded {n} samples in {embed_s:.2f}s ({n / embed_s:.1f} videos/s)")
        path = out_path if len(loaders) == 1 else out_path.with_stem(f"{out_path.stem}_{i}")
        np.savez(path, **cat, paths=np.asarray(meta["paths"]),
                 raw_captions=np.asarray(meta["raw_captions"]))
        print(f"[extract] wrote {n} samples -> {path}")
        rec = {"cat": cat, "meta": meta, "sims": None, "results": None,
               "embed_s": embed_s, "sims_s": None}
        if args.topk:
            t0 = time.perf_counter()
            sims = serve.combined_sims(cat, device, mscoco_dedup=mscoco_dedup, **score)
            # under MSCOCO dedup the columns index every 5th gallery row
            gallery_meta = {k: v[::5] for k, v in meta.items()} if mscoco_dedup else meta
            results = serve.topk_retrieval(sims, k=args.topk, query_meta=meta,
                                           gallery_meta=gallery_meta)
            rec["sims_s"] = time.perf_counter() - t0
            print(f"[extract] scored {sims.shape[0]}x{sims.shape[1]} sims + "
                  f"top-{args.topk} index in {rec['sims_s']:.2f}s")
            if mscoco_dedup:
                for r in results:
                    r["topk_indices"] = [5 * j for j in r["topk_indices"]]
            if args.results:
                rp = Path(args.results)
                if len(loaders) > 1:
                    rp = rp.with_stem(f"{rp.stem}_{i}")
                rp.write_text(json.dumps(results, indent=1))
                print(f"[extract] wrote top-{args.topk} results -> {rp}")
            rec["sims"], rec["results"] = sims, results
        records.append(rec)
    return records


if __name__ == "__main__":
    run()
