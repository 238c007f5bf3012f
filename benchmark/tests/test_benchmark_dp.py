"""The data-parallel driver (`train_dp`) on the CPU: two gloo ranks of the
tiny pre-training cell are correct against the reference over the global
batch; a child rank that fails ends the run with its exit code and
stderr printed; a run past its deadline kills the ranks still running;
each run takes a fresh port; `nccl_ms_per_step.train` reads the NCCL
kernels of a hand-made trace, and nothing on one card; the blocked
reference records its local stage as the program's tap does; the controls
over the global batch (control_dp.py) are not correct."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmark import control_dp
from benchmark.harness.spec import Spec, load_module
from benchmark.harness.trace import Trace
from benchmark.tests.frames_tiny import make_root
from benchmark.tests.tiny import BENCH, REPO, run_cell

DRIVER = BENCH / "drivers" / "train_dp.py"


def test_driver_loads_and_ports_are_fresh():
    mod = load_module(DRIVER, "_bench_driver_train_dp_test")
    assert callable(mod.run)
    ports = {mod.free_port() for _ in range(4)}
    assert len(ports) >= 3 and all(1024 <= p < 65536 for p in ports)


def test_committed_cell_resolves():
    spec = Spec(REPO)
    if "pt_cc_f1_dp4" not in spec.cells:
        pytest.skip("pt_cc_f1_dp4 is not a cell of this checkout's BENCHMARK.json")
    cell = spec.cell("pt_cc_f1_dp4")
    traffic = spec.traffic(cell.traffic)
    assert cell.chips == 4 == traffic["ranks"] and traffic["driver"] == "train_dp"
    assert "nccl_ms_per_step.train" in {m.name for m in spec.per_layer_of(cell.name)}


def test_two_gloo_ranks_are_correct(tmp_path):
    root = make_root(tmp_path)
    rc, result, err = run_cell(root, "dp", seconds=2)
    assert rc == 0, err[-3000:]
    assert result["correct"] is True and result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "update_gap", "local_score_gap",
                                     "local_grad_gap"}


def _ranks_script(tmp_path, job):
    """A process that starts the children of `job` and waits, as rank 0
    would; the watchdog decides how it ends."""
    (tmp_path / "job.json").write_text(json.dumps(job))
    return ("import sys, time; sys.path.insert(0, %r)\n"
            "from pathlib import Path\n"
            "from benchmark.harness.spec import load_module\n"
            "mod = load_module(Path(%r), 'train_dp')\n"
            "r = mod.Ranks(mod.json.loads(Path(%r).read_text()), Path(%r), Path(%r))\n"
            "time.sleep(120)\n" % (str(REPO), str(DRIVER), str(tmp_path / "job.json"),
                                    str(tmp_path / "job.json"), str(tmp_path)))


def test_failed_rank_ends_the_run_with_its_stderr(tmp_path):
    job = {"root": str(REPO), "ranks": 2, "port": "no-port", "backend": "gloo",
           "traffic": {"deadline_s": 100}}  # the child's rendezvous refuses the port
    out = subprocess.run([sys.executable, "-c", _ranks_script(tmp_path, job)],
                         capture_output=True, text=True, timeout=110)
    assert out.returncode == 1
    assert "rank 1 exited with code 1" in out.stderr and "ValueError" in out.stderr
    assert "passed its deadline" not in out.stderr


def test_deadline_kills_stragglers(tmp_path):
    from benchmark.drivers.train_dp import free_port

    job = {"root": str(REPO), "ranks": 2, "port": free_port(), "backend": "gloo",
           "traffic": {"deadline_s": 20}}  # the child waits for a rank 0 that never joins
    out = subprocess.run([sys.executable, "-c", _ranks_script(tmp_path, job)],
                         capture_output=True, text=True, timeout=110)
    assert out.returncode == 1
    assert "passed its deadline" in out.stderr and "rank 1 still running: killed" in out.stderr


def test_nccl_ms_per_step_on_a_hand_made_trace():
    read = load_module(BENCH / "metrics" / "nccl_ms_per_step.train.py", "_nccl_test").read
    t = Trace(window=(0.0, 10000.0))
    t.kernels = [("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 100.0, 600.0),
                 ("gemm", 600.0, 900.0), ("ncclDevKernel_AllGather_RING_LL", 1000.0, 1250.0)]
    assert read({"kind": "train", "steps": 2, "trace": t}) == pytest.approx(0.375)
    t.kernels = [("gemm", 600.0, 900.0)]
    assert read({"kind": "train", "steps": 2, "trace": t}) is None


def _at_stated_precision(root):
    """The tiny dp cell at the precisions the cell states (bf16 towers, bf16
    local stage), as the controls are read."""
    path = root / "benchmark" / "configs" / "tiny_dp.json"
    text = path.read_text().replace('"compute": "float32"', '"compute": "bfloat16"')
    path.write_text(text.replace('"local_dtype": "float32"', '"local_dtype": "bfloat16"'))
    spec = Spec(root)
    cell = spec.cell("dp")
    return spec.config(cell.config)["program"], spec.traffic(cell.traffic)


def test_blocked_reference_records_its_local_stage(tmp_path):
    from benchmark.harness.weights import params_on
    from benchmark.reference import checks, data, dp, model

    cfg, traffic = _at_stated_precision(make_root(tmp_path))
    w, dev = model.Widths.from_config(cfg), torch.device("cpu")
    inputs = data.Inputs(5, 64, w.frames, w.regions, dev)
    batches = dp.global_batches(inputs, 5, 2, 4, 2)
    p0 = params_on(model.param_shapes(w), 5, dev)
    records: list = []
    ref = dp.reference_train(cfg, 5, batches, p0, dev, 2, 3, record=records)
    assert len(records) == 2 and len(ref["losses"]) == 2
    rec = records[0]
    assert rec["scores"].shape == (8, 8) and rec["g_im"].shape == rec["im"].shape
    # float32 against float64, blocks of 3 rows over 8: summation order alone
    gaps = dp.compare_local(records, checks.loss_args(cfg), dev, 3)
    assert gaps["local_score_gap"] < 1e-5 and gaps["local_grad_gap"] < 1e-4, gaps


@pytest.mark.parametrize("variant", control_dp.VARIANTS)
def test_controls_over_the_global_batch_fail(tmp_path, variant):
    root = make_root(tmp_path)
    _at_stated_precision(root)
    lines = control_dp.main(["--workload", "dp", "--seeds", "3", "4", "--variant", variant],
                            root=root, device="cpu")
    assert lines and all(line["correct"] is False and line["failed"] for line in lines), lines
