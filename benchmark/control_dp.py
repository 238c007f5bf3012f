"""The controls of a data-parallel cell's comparison (`train_dp`), read
without the program, as control.py reads the one-card cells': the
reference over the global batch put in the program's place, computed one
step below the configuration's stated precision, and compared with the
float32 reference over the same global batches (reference/dp.py: each
rank's shard, each rank's dropout masks, the local stage in blocks of
`local_block` rows) as a run compares the program. Each is judged against
the cell's limits as a run is (harness/outcome.py) and must come out not
correct. One card does it: the comparison needs no second rank.

    python3 benchmark/control_dp.py --workload pt_cc_f1_dp4 --seeds 11 12 13 \\
        [--variant control]

Variants: `control` (the towers and the local stage each one step below
its stated precision); `control_local` (the towers at their stated
precision, the local stage one step below its own). Prints one JSON line
per seed, with `correct`.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional, Sequence

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.harness.outcome import Check, Outcome  # noqa: E402
from benchmark.harness.spec import Spec  # noqa: E402
from benchmark.harness.weights import params_on  # noqa: E402
from benchmark.reference import checks, data, dp, model  # noqa: E402
from benchmark.reference.precision import AT, BELOW, straight_through  # noqa: E402

VARIANTS = ("control", "control_local")


def reading(cfg: dict, traffic: dict, seed: int, variant: str, device) -> dict:
    if variant not in VARIANTS:
        raise ValueError(f"no variant {variant!r}: expected one of {VARIANTS}")
    w = model.Widths.from_config(cfg)
    ranks, block = int(traffic["ranks"]), int(traffic["local_block"])
    per_rank = int(cfg["data_loader"]["args"]["batch_size"])
    inputs = data.Inputs(seed, int(traffic["samples_per_epoch"]), w.frames, w.regions, device)
    batches = dp.global_batches(inputs, seed, ranks, per_rank, int(traffic["check_steps"]))
    p0 = params_on(model.param_shapes(w), seed, device)
    ref = dp.reference_train(cfg, seed, batches, p0, device, ranks, block)
    compute = cfg.get("precision", {}).get("compute", "float32")
    towers = BELOW[compute] if variant == "control" else AT[compute]
    local = BELOW[cfg["loss"]["args"].get("local_dtype", "float32")]
    records: list = []
    side = dp.reference_train(cfg, seed, batches, p0, device, ranks, block,
                              op_t=straight_through(towers), op_l=straight_through(local),
                              record=records)
    detail: dict = {}
    numbers = checks.compare_train(side, ref, p0, detail)
    numbers.update(dp.compare_local(records, checks.loss_args(cfg), device, block))
    return dict(numbers, detail=detail)


def main(argv: Optional[Sequence[str]] = None, *, root: Optional[Path] = None,
         device: Optional[str] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, type=int, nargs="+")
    p.add_argument("--variant", default="control", choices=VARIANTS)
    args = p.parse_args(argv)
    spec = Spec(root or ROOT)
    cell = spec.cell(args.workload)
    config, traffic = spec.config(cell.config), spec.traffic(cell.traffic)
    if traffic["driver"] != "train_dp":
        raise SystemExit(f"{cell.name} is not a data-parallel cell (driver "
                         f"{traffic['driver']!r})")
    if device is None and not torch.cuda.is_available():
        raise SystemExit("control readings are made on a CUDA card")
    dev = torch.device(device or "cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for seed in args.seeds:
        r = reading(config["program"], traffic, seed, args.variant, dev)
        limits = traffic["limits"]
        judged = Outcome(setup_s=0.0, end_to_end={}, attempted=0, failed=0, device={},
                         checks=[Check(name, float(r[name]), float(limit))
                                 for name, limit in limits.items()])
        line = {"workload": cell.name, "variant": args.variant, "seed": seed,
                "correct": judged.correct, "failed": [c.name for c in judged.checks if not c.ok],
                "limits": limits, **r}
        print(json.dumps(line), flush=True)
        out.append(line)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
