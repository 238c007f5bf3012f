"""The controls and planted faults of the pixel cell's comparison (Frozen
in Time), read without the program, as control.py reads the region
cells': the reference put in the program's place, computed one step below
the configuration's stated precision (both towers' product operands in
float8 e4m3, one scale per tensor, below bfloat16: reference/precision.py),
or with a fault planted, and compared with the float32 reference as a run
compares the program. Each is judged against the cell's limits as a run
is (harness/outcome.py) and must come out not correct.

    python3 benchmark/control_frozen.py --workload ft_msrvtt_frozen4f --seeds 11 12 13 \\
        [--variant control]

Variants: `control`; `half_batch` (the loss over half the rows). A state
left unchanged reads 1 on update_gap by its definition and needs no run.
Prints one JSON line per seed, with `correct`.
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
from benchmark.reference import checks, data, frozen, frozen_steps  # noqa: E402
from benchmark.reference.frames import FrameInputs  # noqa: E402
from benchmark.reference.precision import BELOW, straight_through  # noqa: E402

VARIANTS = ("control", "half_batch")


def reading(cfg: dict, traffic: dict, seed: int, variant: str, device) -> dict:
    w = frozen.Widths.from_config(cfg)
    batch = int(cfg["data_loader"]["args"]["batch_size"])
    n_check = int(traffic["check_steps"])
    chunk = int(traffic["reference_chunk"])
    inputs = FrameInputs(seed, int(traffic["samples_per_epoch"]), w.frames, w.resolution,
                         int(traffic["pool"]), device)
    order = data.train_order(seed, 1, inputs.n)
    batches = [inputs.batch(order[i * batch:(i + 1) * batch]) for i in range(n_check)]
    p0 = params_on(frozen.param_shapes(w), seed, device)
    ref = frozen_steps.reference_train(cfg, seed, batches, p0, device, chunk=chunk)
    if variant == "control":
        op = straight_through(BELOW[cfg.get("precision", {}).get("compute", "float32")])
        side = frozen_steps.reference_train(cfg, seed, batches, p0, device, op=op, chunk=chunk)
    elif variant == "half_batch":
        side = frozen_steps.reference_train(cfg, seed, batches, p0, device, chunk=chunk,
                                            half_batch=True)
    else:
        raise ValueError(f"no variant {variant!r}: expected one of {VARIANTS}")
    detail: dict = {}
    return dict(checks.compare_train(side, ref, p0, detail), detail=detail)


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
    if traffic["driver"] != "train_frames":
        raise SystemExit(f"{cell.name} is not a pixel cell (driver {traffic['driver']!r})")
    if device is None and not torch.cuda.is_available():
        raise SystemExit("control readings are made on a CUDA card")
    dev = torch.device(device or "cuda:0")
    frozen.no_tf32()
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
