"""The benchmark of demovlp_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. The cell (BENCHMARK.json `workloads`) names a configuration
(benchmark/configs/) and a traffic (benchmark/traffic/), whose file names
its driver (benchmark/drivers/). The driver sets up from the seed, runs
the window for `--seconds` and checks what the window produced against the
plain reference (benchmark/reference/). With `--trace 0` the result holds
the cell's end-to-end metrics; with `--trace 1` a profiler session spans
the window and the result holds the cell's per-layer metrics, each read by
its own file under benchmark/metrics/.

The last line of standard output is the result (JSON); the last lines of
standard error are the compared numbers beside their limits. Without a
CUDA card, or with fewer cards than the cell asks for, the run prints no
result and exits 2. It exits 3, with no result, if JAX or the JAX package
was loaded in this process.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# every kernel cache at a fixed path inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton_cache"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "cuda_cache"))
os.environ.setdefault("USE_FLAX", "0")

from benchmark.harness.outcome import (forbidden_modules, process_start, report_checks,  # noqa: E402
                                       result_line)
from benchmark.harness.spec import Spec  # noqa: E402
from benchmark.harness.trace import breakdown  # noqa: E402

_T_START = process_start()


@dataclass
class RunContext:
    """What a driver gets: the cell's data and the run's arguments."""
    root: Path
    cell: str
    seed: int
    seconds: float
    trace: bool
    device: Any
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    t_start: float
    out_dir: Path


def parse(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", required=True, type=int, choices=(0, 1))
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, *, root: Optional[Path] = None,
         device: Optional[str] = None) -> int:
    """One run. `root` and `device` are for the harness's own tests: another
    checkout root, and a device to use without looking for a card."""
    args = parse(argv)
    spec = Spec(root or ROOT)
    cell = spec.cell(args.workload)
    config, traffic = spec.config(cell.config), spec.traffic(cell.traffic)
    driver = spec.driver(traffic["driver"])
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{cell.name} needs {cell.chips} CUDA card(s); {have} visible", file=sys.stderr)
            return 2
        from demovlp_tpu_torch.device import resolve_device

        dev = resolve_device("cuda:0")
    else:
        dev = torch.device(device)
    # float32 products in float32 on both sides
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="demovlp_bench_") as out:
        ctx = RunContext(spec.root, cell.name, args.seed, args.seconds, bool(args.trace), dev,
                         cell.chips, config, traffic, _T_START, Path(out))
        outcome = driver.run(ctx)
    metrics: Dict[str, Dict[str, Any]] = {}
    parts = None
    if args.trace:
        tr = outcome.window.get("trace")
        if tr is None or not tr.device_events():
            print("the traced window holds no device activity", file=sys.stderr)
            return 4
        for m in spec.per_layer_of(cell.name):
            value = spec.metric_reader(m.name).read(outcome.window)
            if value is not None:
                metrics[m.name] = {"value": float(value), "unit": m.unit}
        outcome.device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        parts = breakdown(tr)
    else:
        for m in spec.end_to_end_of(cell.name):
            if m.name not in outcome.end_to_end:
                raise KeyError(f"driver {traffic['driver']!r} does not measure {m.name}")
            metrics[m.name] = {"value": float(outcome.end_to_end[m.name]), "unit": m.unit}
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the benchmark may not load: {found}", file=sys.stderr)
        return 3
    print(f"[bench] {cell.name} seed {args.seed}: setup {outcome.setup_s:.3f} s, window "
          f"{outcome.window.get('window_s', 0.0):.3f} s, reference "
          f"{outcome.window.get('reference_s', 0.0):.3f} s", file=sys.stderr)
    if outcome.window.get("check_detail"):
        print(f"[bench] detail {json.dumps(outcome.window['check_detail'])}", file=sys.stderr)
    report_checks(outcome)
    print(result_line(outcome, metrics, parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
