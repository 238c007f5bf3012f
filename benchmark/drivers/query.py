"""Query traffic: a closed loop of one client against a video index.

Set-up builds the index as the embedding-extraction CLI does (the port's
`serve.embed_loader` over the port's loader, here over the run's inputs,
harness/dataset.py; the model in eval mode with the seed's weights made
on the card), warms the call's shapes,
then the window issues `serve.query_retrieval` calls of `queries_per_call`
free-text queries (harness/traffic.py), the next issued when one's top-k
results are on the host; the window ends once the last call returns. The
calls to check are drawn from the seed as the window runs (a reservoir of
`checked_calls`), each kept with the scores and the query embeddings the
program made for it. After the window the peak memory is read, the
program's state freed, and the reference scores the drawn calls
(reference/checks.py).
"""
from __future__ import annotations

import copy
import time
from typing import Any, Dict

import numpy as np
import torch

from benchmark.counts import flops as counts
from benchmark.harness import trace as tracing
from benchmark.harness.dataset import make_loader
from benchmark.harness.outcome import Check, Outcome, device_info
from benchmark.harness.traffic import query_calls
from benchmark.harness.weights import init_params, params_on
from benchmark.reference import checks, data, model as ref_model


def program_config(config: Dict[str, Any]) -> Dict[str, Any]:
    return copy.deepcopy(config["program"])


def run(ctx) -> Outcome:
    from demovlp_tpu_torch import serve
    from demovlp_tpu_torch.cli import common
    from demovlp_tpu_torch.ops import cuda_build
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    traffic = ctx.traffic
    device = ctx.device
    cfg = program_config(ctx.config)
    per_call, k, videos = int(traffic["queries_per_call"]), int(traffic["k"]), int(traffic["videos"])
    if device.type == "cuda":
        cuda_build.build(["xattn_sim_fwd"])
    with torch.device("meta"):
        net = common.build_model(cfg)
    net = net.to_empty(device=device)
    init_params(net.named_parameters(), ctx.seed)
    net.eval()
    notes = []
    w = ref_model.Widths.from_config(cfg)
    if {n: tuple(p.shape) for n, p in net.named_parameters()} != ref_model.param_shapes(w):
        notes.append("the program's parameters are not the configuration's (names or shapes)")
    tokenizer = common.build_tokenizer_from_config(cfg)
    dl = make_loader(data.Inputs(ctx.seed, videos, w.frames, w.regions, device),
                     int(traffic["embed_batch"]), int(traffic["loader_workers"]), ctx.seed,
                     train=False)
    bf16 = common.compute_dtype(cfg) == torch.bfloat16
    index, _ = serve.embed_loader(serve.make_embed_step(net), dl, tokenizer, device,
                                  transfer_dtype=torch.bfloat16 if bf16 else None)
    if index["g_o"].shape[0] != videos:
        notes.append(f"the index holds {index['g_o'].shape[0]} videos, not {videos}")
    step = serve.make_text_embed_step(net)
    score = common.local_score_args(cfg)

    def call(queries):
        return serve.query_retrieval(step, queries, tokenizer, index, device, k=k, **score)

    for queries in query_calls(traffic, ctx.seed, int(traffic["warm_calls"]), per_call, stream=1):
        call(queries)
    pool = query_calls(traffic, ctx.seed, int(traffic["pool_calls"]), per_call, stream=0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    seconds = min(ctx.seconds, float(traffic["trace_seconds"])) if ctx.trace else ctx.seconds
    xk.reset_launch_counts()
    results = []
    n_keep = int(traffic["checked_calls"])
    kept: list = []  # (call, its results, its scores, its query embeddings), drawn from the seed
    rng = np.random.default_rng(np.random.SeedSequence([int(ctx.seed), 99]))
    embedded: Dict[str, Any] = {}
    embed_texts = serve.embed_texts

    def embed_kept(*args, **kwargs):
        embedded["q"] = out = embed_texts(*args, **kwargs)
        return out

    serve.embed_texts = embed_kept
    spans = tracing.HostSpans()
    if ctx.trace:
        for attr in ("embed_texts", "query_sims", "sharded_local_sims", "topk_retrieval"):
            spans.wrap(serve, attr, attr)
    cm = tracing.maybe_traced(ctx.trace, ctx.out_dir)
    setup_s = time.time() - ctx.t_start
    try:
        with cm as holder:
            t0 = tracing.edge(device)
            deadline = t0 + seconds
            while time.perf_counter() < deadline:
                i = len(results)
                if i == len(pool):
                    raise RuntimeError("the window outran the traffic's pool_calls")
                a = time.perf_counter()
                res, sims = call(pool[i])
                results.append(res)
                spans.add("query_call", a, time.perf_counter())
                slot = i if i < n_keep else int(rng.integers(0, i + 1))
                if slot < n_keep:
                    entry = (i, res, sims, embedded["q"])
                    if i < n_keep:
                        kept.append(entry)
                    else:
                        kept[slot] = entry
            window_s = tracing.edge(device) - t0
    finally:
        spans.unwrap()
        serve.embed_texts = embed_texts
    if holder.get("trace") is not None:
        spans.place(holder["trace"], t0)
    calls = len(results)
    launches = dict(xk.SHAPE_LAUNCHES)
    info = device_info(device, ctx.chips)
    gallery = (index["g_o"], index["l_o"], index["o_mask"])
    del net, step, index
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference: its own index, the drawn calls' queries, every pair scored
    t_ref = time.perf_counter()
    kept.sort(key=lambda entry: entry[0])
    la = checks.loss_args(cfg)
    P = params_on(ref_model.param_shapes(w), ctx.seed, device)
    ref_index = checks.embed_index(P, w, data.Inputs(ctx.seed, videos, w.frames, w.regions,
                                                     device), device)
    texts = [q for c, *_ in kept for q in pool[c]]
    ref_sims = checks.query_sims(P, w, texts, ref_index, la, device)
    numbers, malformed = checks.compare_query([res for _, res, _, _ in kept],
                                              ref_sims.cpu().numpy(), k)
    del P, ref_index, ref_sims
    numbers["local_gap"] = checks.scoring_gap(
        np.concatenate([sims for _, _, sims, _ in kept]),
        tuple(np.concatenate([q[key] for _, _, _, q in kept]) for key in ("g_t", "l_t", "t_mask")),
        gallery, la, device)
    limits = traffic["limits"]
    failed = sum(checks.malformed(r, k, videos) for res in results for r in res)
    if malformed:
        notes.append(f"{malformed} checked queries got malformed results")
    regions = w.frames * w.regions
    window = {
        "kind": "query", "units": calls * per_call, "calls": calls, "window_s": window_s,
        "xattn_launches": launches,
        "xattn_items": lambda ls, lq: (videos, per_call) if ls == regions else (per_call, videos),
        "d": w.proj, "local_precision": "float32",
        "flops_per_call": counts.query_call(per_call, videos, w.frames, w.regions, data.TEXT_LEN,
                                            w.proj, w.text_layers, w.text_dim),
        "device_name": info["kind"], "trace": holder.get("trace"),
        "reference_s": time.perf_counter() - t_ref,
    }
    return Outcome(setup_s=setup_s,
                   end_to_end={"queries_per_s": calls * per_call / window_s, "setup_s": setup_s},
                   attempted=calls * per_call, failed=failed,
                   checks=[Check(n, float(v), float(limits[n])) for n, v in numbers.items()],
                   device=info, window=window, notes=notes)

