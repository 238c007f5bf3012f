"""The controls and planted faults of each cell's comparison, read without
the program: the reference put in the program's place, computed one step
below the configuration's stated precision (reference/precision.py), or
with a fault planted, and compared with the reference as a run compares
the program. Each is judged against the cell's limits as a run is
(harness/outcome.py) and must come out not correct; the readings set each
limit's upper end.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 [--variant control]

Variants: `control` (every cell: the towers and the local stage each one
step below its stated precision); `control_local` (every cell: the towers
at their stated precision, the local stage one step below its own);
`half_batch` (training: the loss over half the rows, the mean over the
rest); `answer_altered` (serving: each query's first returned video
swapped for the video the reference ranks last). A state left unchanged
reads 1 on update_gap by its definition and needs no run. Prints one JSON
line per seed, with `correct`. Not run by the benchmark's own runs.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.harness.outcome import Check, Outcome  # noqa: E402
from benchmark.harness.spec import Spec  # noqa: E402
from benchmark.harness.traffic import query_calls  # noqa: E402
from benchmark.harness.weights import params_on  # noqa: E402
from benchmark.reference import checks, data, model  # noqa: E402
from benchmark.reference.precision import AT, BELOW, straight_through  # noqa: E402

VARIANTS = {"train": ("control", "control_local", "half_batch"),
            "query": ("control", "control_local", "answer_altered")}


def _ops(cfg: dict, local: str, variant: str):
    """(tower op, local op) of a control variant."""
    compute = cfg.get("precision", {}).get("compute", "float32")
    towers = BELOW[compute] if variant == "control" else AT[compute]
    return straight_through(towers), straight_through(BELOW[local])


def train_reading(cfg: dict, traffic: dict, seed: int, variant: str, device) -> Dict[str, float]:
    w = model.Widths.from_config(cfg)
    batch = int(cfg["data_loader"]["args"]["batch_size"])
    n_check = int(traffic["check_steps"])
    n = int(traffic["samples_per_epoch"])
    inputs = data.Inputs(seed, n, w.frames, w.regions, device)
    order = data.train_order(seed, 1, n)
    batches = [inputs.batch(order[i * batch:(i + 1) * batch]) for i in range(n_check)]
    p0 = params_on(model.param_shapes(w), seed, device)
    ref = checks.reference_train(cfg, seed, batches, p0, device)
    records: list = []
    if variant in ("control", "control_local"):
        op_t, op_l = _ops(cfg, cfg["loss"]["args"].get("local_dtype", "float32"), variant)
        side = checks.reference_train(cfg, seed, batches, p0, device, op_t=op_t, op_l=op_l,
                                      record=records)
    elif variant == "half_batch":
        side = checks.reference_train(cfg, seed, batches, p0, device, half_batch=True,
                                      record=records)
    else:
        raise ValueError(f"no training variant {variant!r}")
    detail: dict = {}
    numbers = checks.compare_train(side, ref, p0, detail)
    numbers.update(checks.compare_local(records, checks.loss_args(cfg), device))
    return dict(numbers, detail=detail)


def _topk(sims: np.ndarray, k: int) -> List[dict]:
    order = np.argsort(-sims, axis=1)[:, :k]
    return [{"topk_indices": o.tolist(), "topk_scores": sims[q, o].tolist()}
            for q, o in enumerate(order)]


def query_reading(cfg: dict, traffic: dict, seed: int, variant: str, device) -> Dict[str, float]:
    w = model.Widths.from_config(cfg)
    per_call, k, videos = int(traffic["queries_per_call"]), int(traffic["k"]), int(traffic["videos"])
    calls = query_calls(traffic, seed, int(traffic["checked_calls"]), per_call, stream=0)
    texts = [q for c in calls for q in c]
    la = checks.loss_args(cfg)
    P = params_on(model.param_shapes(w), seed, device)
    inputs = data.Inputs(seed, videos, w.frames, w.regions, device)
    ref_index = checks.embed_index(P, w, inputs, device)
    ref_queries = checks.embed_queries(P, w, texts, device)
    ref = checks.score(ref_queries, ref_index, la).cpu().numpy()
    if variant in ("control", "control_local"):
        op_t, op_l = _ops(cfg, "float32", variant)
        idx = checks.embed_index(P, w, inputs, device, op=op_t)
        queries = checks.embed_queries(P, w, texts, device, op_t)
        side = checks.score(queries, idx, la, op_l)
        rows = _topk(side.cpu().numpy(), k)
    elif variant == "answer_altered":
        idx, queries, side = ref_index, ref_queries, torch.from_numpy(ref)
        rows = _topk(ref, k)
        for row, r in zip(rows, ref):
            worst = int(np.argmin(r))
            row["topk_indices"][0] = worst
            row["topk_scores"][0] = float(r[worst])
    else:
        raise ValueError(f"no serving variant {variant!r}")
    results = [rows[i * per_call:(i + 1) * per_call] for i in range(len(calls))]
    numbers, bad = checks.compare_query(results, ref, k)
    numbers["local_gap"] = checks.scoring_gap(side, queries, idx, la, device)
    return dict(numbers, malformed=bad)


def main(argv: Optional[Sequence[str]] = None, *, root: Optional[Path] = None,
         device: Optional[str] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, type=int, nargs="+")
    p.add_argument("--variant", default="control")
    args = p.parse_args(argv)
    spec = Spec(root or ROOT)
    cell = spec.cell(args.workload)
    config, traffic = spec.config(cell.config), spec.traffic(cell.traffic)
    kind = traffic["driver"]
    if args.variant not in VARIANTS[kind]:
        raise SystemExit(f"{args.variant!r} is not a variant of {kind} cells: {VARIANTS[kind]}")
    if device is None and not torch.cuda.is_available():
        raise SystemExit("control readings are made on a CUDA card")
    dev = torch.device(device or "cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fn = train_reading if kind == "train" else query_reading
    cfg = config["program"]
    out = []
    for seed in args.seeds:
        reading = fn(cfg, traffic, seed, args.variant, dev)
        limits = traffic["limits"]
        judged = Outcome(setup_s=0.0, end_to_end={}, attempted=0, failed=0, device={},
                         checks=[Check(name, float(reading[name]), float(limit))
                                 for name, limit in limits.items()],
                         notes=[f"{reading['malformed']} malformed results"]
                         if reading.get("malformed") else [])
        line = {"workload": cell.name, "variant": args.variant, "seed": seed,
                "correct": judged.correct, "failed": [c.name for c in judged.checks if not c.ok],
                "limits": limits, **reading}
        print(json.dumps(line), flush=True)
        out.append(line)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
