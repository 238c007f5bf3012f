"""Free-text top-k retrieval against an embedding index (counterpart of
scripts/query_index.py).

    python -m demovlp_tpu_torch.cli.extract_embeddings -c CFG [-r W.pth] --output emb.npz
    python -m demovlp_tpu_torch.cli.query_index -c CFG [-r W.pth] --index emb.npz \\
        --query "a man cooking pasta" --query "a dog catches a frisbee" \\
        [--queries-file q.txt] [-k 5] [--output results.json] [--device cpu]

Runs the text tower only on the query strings, tokenized as the trainer
tokenizes, and scores them against the index's video embeddings as the
trainer scores eval: global cosine plus, where the config's loss uses them
and the index holds `l_o`, the local sims through the f32 forward kernel.
No dataset is built: the gallery is the index npz. `-r` takes a
reference-schema `.pth`; without it the weights are seeded random init
(--seed). Runs on the card unless `--device cpu` is given; with no card it
raises.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

from demovlp_tpu_torch import serve
from demovlp_tpu_torch.cli.common import (build_serving_model, build_tokenizer_from_config,
                                          local_score_args, setup_parallel)
from demovlp_tpu_torch.config import build_argparser, read_config
from demovlp_tpu_torch.parallel.mesh import is_main_process


def _parser():
    p = build_argparser("free-text queries against an embedding index (PyTorch port)")
    p.add_argument("--index", required=True, help="embeddings npz from cli.extract_embeddings")
    p.add_argument("--query", action="append", default=[], help="query string (repeatable)")
    p.add_argument("--queries-file", default="", help="file with one query a line")
    p.add_argument("-k", "--topk", type=int, default=10)
    p.add_argument("--output", default="", help="JSON path for the results (default: stdout)")
    return p


def run(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the CLI; returns {results, sims (query, gallery), seconds}."""
    parser = _parser()
    args = parser.parse_args(argv)
    queries = list(args.query)
    if args.queries_file:
        queries += [line.strip() for line in Path(args.queries_file).read_text().splitlines()
                    if line.strip()]
    if not queries:
        parser.error("no queries: pass --query and/or --queries-file")
    config = read_config(args.config)
    device, mesh = setup_parallel(args.device, config)
    model = build_serving_model(config, device, args.resume, args.seed, mesh=mesh)
    tokenizer = build_tokenizer_from_config(config)
    gallery, gallery_meta = serve.load_index(args.index)
    score = local_score_args(config)
    score["use_local"] = score["use_local"] and "l_o" in gallery
    t0 = time.perf_counter()
    results, sims = serve.query_retrieval(
        serve.make_text_embed_step(model), queries, tokenizer, gallery, device, k=args.topk,
        mscoco_dedup=str(config["name"]).startswith("MSCOCO"),
        gallery_meta=gallery_meta if "paths" in gallery_meta else None, mesh=mesh, **score)
    seconds = time.perf_counter() - t0
    if not is_main_process():
        return {"results": results, "sims": sims, "seconds": seconds}
    print(f"[query] {len(queries)} queries x {gallery['g_o'].shape[0]} gallery videos in "
          f"{seconds:.3f}s")
    if args.output:
        Path(args.output).write_text(json.dumps(results, indent=1))
        print(f"[query] wrote top-{args.topk} results -> {args.output}")
    else:
        print(json.dumps(results, indent=1))
    return {"results": results, "sims": sims, "seconds": seconds}


if __name__ == "__main__":
    run()
