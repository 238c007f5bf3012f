"""A scratch checkout for the harness's CPU tests: the benchmark's folder
copied beside a BENCHMARK.json whose cells run the committed configurations
and traffic narrowed to a size the CPU runs in seconds (every width cut,
small batches, short windows). The program is imported from this
repository."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"

TEXT = {"vocab_size": 30522, "dim": 32, "n_layers": 2, "n_heads": 2, "hidden_dim": 64,
        "max_position_embeddings": 128, "dropout": 0.1, "attention_dropout": 0.1,
        "layer_norm_eps": 1e-12}


def _narrow(config: dict, batch: int, precision: str) -> dict:
    c = copy.deepcopy(config)
    p = c["program"]
    if precision == "float32":
        p["precision"]["compute"] = "float32"
        p["loss"]["args"]["local_dtype"] = "float32"
    a = p["arch"]["args"]
    a["text_params"]["config"] = dict(TEXT)
    a["object_params"].update(embed_dim=32, depth=2, heads=2)
    a["projection_dim"] = 16
    p["data_loader"]["args"]["batch_size"] = batch
    return c


def make_root(tmp: Path, precision: str = "configured") -> Path:
    """A checkout root under `tmp` with tiny cells `pt`, `ft` and `query`,
    at the configurations' precisions or, with `precision` "float32", with
    every product in float32 (where a sound run agrees with the reference
    to rounding at any width, so a planted fault stands out from it)."""
    root = Path(tmp) / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfgs = root / "benchmark" / "configs"
    traffic = root / "benchmark" / "traffic"
    for name, batch in (("demovlp_pt_f1", 8), ("demovlp_f8", 4)):
        c = json.loads((cfgs / f"{name}.json").read_text())
        (cfgs / f"tiny_{name}.json").write_text(json.dumps(_narrow(c, batch, precision)))
    for cell, extra in (("pt_cc_f1", {"samples_per_epoch": 8192, "trace_seconds": 1}),
                        ("ft_msrvtt_f8", {"samples_per_epoch": 4096, "trace_seconds": 1}),
                        ("query_1k_f8", {"videos": 24, "embed_batch": 8, "queries_per_call": 6,
                                         "pool_calls": 400, "checked_calls": 2,
                                         "trace_seconds": 1})):
        t = json.loads((traffic / f"{cell}.json").read_text())
        t.update(extra)
        (traffic / f"tiny_{cell}.json").write_text(json.dumps(t))
    bench["workloads"] = [
        {"name": "pt", "config": "tiny_demovlp_pt_f1", "traffic": "tiny_pt_cc_f1", "chips": 1,
         "why": "tiny pre-training"},
        {"name": "ft", "config": "tiny_demovlp_f8", "traffic": "tiny_ft_msrvtt_f8", "chips": 1,
         "why": "tiny fine-tuning"},
        {"name": "query", "config": "tiny_demovlp_f8", "traffic": "tiny_query_1k_f8", "chips": 1,
         "why": "tiny query serving"},
    ]
    rename = {"pt_cc_f1": "pt", "ft_msrvtt_f8": "ft", "query_1k_f8": "query"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_cell(root: Path, cell: str, seconds: float = 1.0, seed: int = 4294967311):
    """(exit code, result dict or None, stderr) of one CPU run of `cell`."""
    import contextlib
    import io

    import benchmark.run as run

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", "0"], root=root, device="cpu")
    lines = out.getvalue().strip().splitlines()
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, result, err.getvalue()
