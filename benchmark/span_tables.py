"""The program's span tables for traced runs of benchmark cells.

    python3 benchmark/span_tables.py <out dir> <cell> <seed> [<cell> <seed> ...]

Each pair makes one traced run as `benchmark/run.py --trace 1` makes it,
on `cuda:0`, and writes `<out dir>/<cell>-<seed>.json`: the
correctness verdict, the window's steps or calls, the cell's per-layer
metrics and `harness/program_spans.summary` (the device's idle time by
the innermost program span, each span's count and time, the staging
rates, the loader's overlap with the training loop's spans). A line of
each goes to standard output.
"""
from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import benchmark.run as run  # noqa: E402  (sets the kernel caches' paths)
from benchmark.harness import program_spans  # noqa: E402
from benchmark.harness.spec import Spec  # noqa: E402


def main(argv) -> int:
    import torch

    from demovlp_tpu_torch.device import resolve_device
    from demovlp_tpu_torch.utils import profiling

    out_dir = Path(argv[0])
    out_dir.mkdir(parents=True, exist_ok=True)
    spec = Spec(ROOT)
    device = resolve_device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for cell, seed in zip(argv[1::2], argv[2::2]):
        c = spec.cell(cell)
        config, traffic = spec.config(c.config), spec.traffic(c.traffic)
        profiling.clear()
        with tempfile.TemporaryDirectory(prefix="demovlp_bench_") as tmp:
            ctx = run.RunContext(ROOT, cell, int(seed), 50.0, True, device, c.chips, config,
                                 traffic, time.time(), Path(tmp))
            outcome = spec.driver(traffic["driver"]).run(ctx)
        w = outcome.window
        report = {"cell": cell, "seed": int(seed), "correct": outcome.correct,
                  "device": torch.cuda.get_device_name(device), "steps": w.get("steps"),
                  "calls": w.get("calls"), "window_s": w.get("window_s"),
                  "metrics": {m.name: spec.metric_reader(m.name).read(w)
                              for m in spec.per_layer_of(cell)},
                  "dropped": profiling.recorded()["dropped"],
                  "summary": program_spans.summary(w)}
        (out_dir / f"{cell}-{seed}.json").write_text(json.dumps(report, indent=1))
        print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
