#!/usr/bin/env python3
"""Build and run the PyTorch port (demovlp_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, and no result line):
  1. device   — needs a CUDA card; prints its name and power limit;
  2. build    — nvcc for sm_90a on every csrc/*.cu, all in parallel, with
                the ptxas register / shared-memory summary;
  3. kernels  — each kernel against its plain PyTorch version: the f32
                forward at serving widths (D=256, 240 regions, 99 words),
                then at the training shapes (128 x 128 items, D=256,
                (Ls, Lq) = (30, 99) and (99, 30)) the forward in both modes
                and the two backward kernels in both modes, each backward
                run twice and required bit-identical; both directions, both
                focal types, padded and fully masked items included;
  4. reference — the serving CLI on the small smoke config, on the card
                and on the CPU, must agree;
  5. serve    — the serving CLI at full width (DistilBERT 6x768, 12-block
                768-wide region tower, f=8 x k=30, bf16, seeded weights)
                over the 1000-video synthetic gallery of
                configs/bench/serve_synthetic_1k.json: embed, local sims
                through the kernel (launch counts reset just before and
                read just after), top-10;
  6. bf16     — the first batch of that serve again on the CPU: the card's
                bf16 embeddings must agree with it;
  7. train-ref — two deterministic train steps of the f32 smoke config on
                the card and on the CPU from the same weights and batches:
                losses, step-1 gradients and parameters must agree;
  8. train    — the train CLI at full width on configs/bench/ab_local_bf16.json
                (f=1 x k=30, batch 128, bf16 towers and local loss, one
                epoch = 16 steps, then validation over the val split), the
                launch counts reset just before and read just after;
  9. train-local — on that run's first batch, the local loss and its
                gradients through the kernels and through the plain versions;
 10. finetune-ref — two deterministic f32 train steps at f = 8 x k = 30 with
                narrow towers, on the card and on the CPU from the same
                weights, inflated from an f = 1 checkpoint: as train-ref;
 11. finetune — the train CLI at full width on
                configs/bench/ft_synthetic_f8.json (f = 8 x k = 30, batch 32,
                bf16 towers, f32 local loss, 16 steps, validation) starting
                from the train phase's f = 1 checkpoint (temporal embed
                inflated), launch counts reset just before and read just after;
 12. qa       — train_qa at full width on configs/bench/qa_synthetic_f8.json
                (batch 64, 1500 answers, 16 steps, a val pass); card vs CPU
                on the f32 smoke config: losses and logits of two steps;
 13. mc       — train_mc at full width on configs/bench/mc_synthetic_f8.json
                (256 items, 5 options, 8 items a call); card vs CPU on the
                smoke config: the option scores;
 14. timing   — each kernel and its plain version on the main paths' own
                inputs, beside the card's bound for the same work: the
                serving forward, the training kernels at f = 1 and the
                backward kernels at f = 8 (the fine-tune's first batch),
                grouped attention at the region tower's f = 8 shapes beside
                torch's scaled_dot_product_attention; and one step each of
                the train and fine-tune runs split into towers, loss,
                backward and optimizer, and by kernel with the profiler.
Phase 3 also holds the backward kernels at the f = 8 shapes (32 x 32 items,
(Ls, Lq) = (240, 99) and (99, 240)) and the grouped-attention kernel at the
region tower's f = 8 shapes against their plain versions, and an
attention-op phase drives `grouped_attention_fused` (forward and backward)
at those shapes, its launch count reset just before and read just after.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SERVE_CFG = ROOT / "configs" / "bench" / "serve_synthetic_1k.json"
TRAIN_CFG = ROOT / "configs" / "bench" / "ab_local_bf16.json"
FT_CFG = ROOT / "configs" / "bench" / "ft_synthetic_f8.json"
QA_CFG = ROOT / "configs" / "bench" / "qa_synthetic_f8.json"
MC_CFG = ROOT / "configs" / "bench" / "mc_synthetic_f8.json"
SMOKE_CFG = ROOT / "configs" / "smoke" / "synthetic_retrieval.json"
SMOKE_QA_CFG = ROOT / "configs" / "smoke" / "synthetic_qa.json"
SMOKE_MC_CFG = ROOT / "configs" / "smoke" / "synthetic_mc.json"
# the region tower's grouped attention at f = 8, k = 30, batch 32, 12 heads,
# hd = 64, as (groups, query rows, keys): space (a frame's regions and the
# CLS key), time (a region over the frames and the CLS key), the CLS row over
# everything, and full attention
ATTN_SHAPES = {"space": (3072, 30, 31), "time": (11520, 8, 9), "cls": (384, 1, 241),
               "full": (384, 241, 241)}
# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores, dense bf16 on the tensor cores, and device-memory bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# kernel vs plain (both f32, summation order only): 'prob' is smooth, so
# 1e-4; focal 'equal' thresholds at the row mean, and a position within
# rounding of it can fall on either side — that moves one of Lq cosines by
# O(1/Ls) and the sim by < 2e-3; such flips must stay rare (<= 0.01%)
TOL_SMOOTH = 1e-4
TOL_FLIP = 2e-3
MAX_FLIP_SHARE = 1e-4
# full-width bf16 towers, card vs CPU, max |err| / max |CPU value| per
# embedding: the same rounding sites on both, so only bf16 round-off flips
# from the products' summation order, carried through 12 blocks. Read on
# an H100 80GB HBM3 (700 W limit): 0.0101 g_t, 0.0119 g_o, 0.0112 l_t,
# 0.0130 l_o; the limit is about 2.3x the largest
TOL_BF16_CARD = 0.03
# training-shape kernels against their plain versions, relative to the
# largest entry of the plain result (max |err| / max |plain|). 'prob' in
# f32 is summation order only. Under focal 'equal' a near-tie flip moves
# one position's weight, and in bf16 mode a last-digit difference before
# an operand's rounding moves that operand by one bf16 ulp (2^-8); each
# moves a few entries by much more than the rest, so those are held at a
# looser limit for the largest error with the share beyond the tight one
# kept small. Read on an H100 80GB HBM3 (700 W limit), training shapes at
# f = 1: f32 2.7e-6 at most (forward and backward), bf16 forward 7.2e-5 and
# bf16 backward 1.6e-3, no flip beyond these in either focal type; at f = 8
# (32 x 32 items): f32 2.4e-6 at most, bf16 forward 3.0e-5, bf16 backward
# 3.7e-3 with at most 4.8e-5 of the entries beyond 2e-3.
TOL_TRAIN = {"f32": 1e-5, "bf16": 2e-3}
TOL_TRAIN_FLIP = 2e-2
MAX_TRAIN_FLIP_SHARE = 1e-2
# card vs CPU on two f32 smoke train steps: as tests/test_torch_train.py
# holds the port against JAX (summation order, amplified by lambda = 20)
TRAIN_REF_LOSS_RTOL = 1e-5
TRAIN_REF_GRAD = dict(rtol=1e-3, atol=1e-6, scale_atol=1e-4)
TRAIN_REF_PARAM = dict(rtol=1e-5, atol=1e-6, max_loose_share=5e-3)
# the full-width local loss and its gradients, kernels vs plain versions,
# both in bf16 mode. The loss at rtol 1e-4. A gradient is two directions'
# shares, and each share a sum over the other side's items of g[c, q]
# times that pair's gradient. The loss's cotangent g has rows that sum to
# zero, and at random init the pairs' gradients are alike, so the sums
# cancel: the result can be 1000x smaller than its terms, and the terms'
# bf16 rounding is then large against it. So each share is held as the
# kernels are (TOL_TRAIN["bf16"], with flips) against the same share
# computed with |g|, whose sums have no cancellation; the gradient (two
# shares) at twice that against the larger of the two
TRAIN_LOCAL_LOSS_RTOL = 1e-4
# grouped attention, kernel vs plain on the card, max |err| / max |plain|:
# f32 differs by expf and summation order only; in bf16 both round the
# probabilities and the result to bf16, so a last-digit difference before
# a rounding is one bf16 ulp (2^-8 of the value). Read on an H100 80GB HBM3
# (700 W limit), f = 8 tower shapes: f32 6.5e-7 at most, bf16 1.1e-3 at most
TOL_ATTN = {"f32": 1e-5, "bf16": 2.0 ** -7}
# QA and MC on the f32 smoke configs, card vs CPU: the QA losses as
# train-ref holds the retrieval losses; logits after two steps as the
# towers are held (rtol 1e-4 / atol 1e-5, tests/test_torch_models.py); MC
# scores as the smoke serve's sims are held (check_close 'equal', with room
# for a flipped entry)
QA_LOGITS_TOL = dict(rtol=1e-4, atol=1e-5)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, focal: str,
                max_share: float = MAX_FLIP_SHARE) -> float:
    err = (got - want).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite kernel output")
    share = float((err > TOL_SMOOTH).float().mean()) if err.numel() else 0.0
    log(f"[kernels] {name}: max_abs_err {max_err:.3e}, share > {TOL_SMOOTH:g}: {share:.2e}")
    if focal == "prob" and max_err > TOL_SMOOTH:
        fail(f"{name}: max_abs_err {max_err} > {TOL_SMOOTH}")
    if focal == "equal" and (max_err > TOL_FLIP or share > max_share):
        fail(f"{name}: max_abs_err {max_err} (limit {TOL_FLIP}), share {share} "
             f"(limit {max_share})")
    return max_err


def check_rel(name: str, got: torch.Tensor, want: torch.Tensor, tol: float,
              flip_tol: float = 0.0, max_share: float = 0.0,
              scale: float | None = None) -> float:
    """max |got - want| / scale within tol, or within flip_tol with at most
    max_share of the entries beyond tol * scale; the scale is max |want|
    unless given. Returns the max abs error."""
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite kernel output")
    err = (got.float() - want.float()).abs()
    what = "max |plain|" if scale is None else "scale"
    scale = scale or float(want.abs().max()) or 1.0
    rel = float(err.max()) / scale
    share = float((err > tol * scale).float().mean())
    log(f"[kernels] {name}: max |err| / {what} {rel:.3e} ({what} {scale:.3e}, max |plain| "
        f"{float(want.abs().max()):.3e}), share beyond {tol:g}: {share:.2e}")
    if rel > tol and (rel > flip_tol or share > max_share):
        fail(f"{name}: relative error {rel} (limit {tol}, or {flip_tol} with share "
             f"{share} <= {max_share})")
    return float(err.max())


def timed(fn, reps: int):
    """(result, ms per call) with CUDA events, after one warm-up call."""
    out = fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop) / reps


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi exited {smi.returncode}: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {name}; count {torch.cuda.device_count()}; torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    log("[device] nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    log(card)
    return name


def phase_build():
    from demovlp_tpu_torch.ops import cuda_build

    names = sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    logs = cuda_build.build(names)
    log(f"[build] {names} in {time.perf_counter() - t0:.1f}s (nvcc {' '.join(cuda_build.NVCC_FLAGS)})")
    for name in names:
        for line in logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] {name}: {line.strip()}")


def _serving_inputs(seed: int, n: int, length: int, d: int, device):
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(n, length, d, generator=g)
    mask = ((torch.rand(n, length, generator=g) > 0.3).float() - 1.0) * 100.0
    feats[-4:] = 0.0  # inert padded rows, as the gallery chunking pads
    mask[-4:] = -100.0
    mask[1] = -100.0  # a real item with every position masked
    return feats.to(device), mask.to(device)


def phase_kernels(device) -> float:
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    vid, vmask = _serving_inputs(0, 64, 240, 256, device)  # regions
    txt, tmask = _serving_inputs(1, 64, 99, 256, device)  # words
    worst = 0.0
    for focal in ("prob", "equal"):
        for direction, (ctx, qry, cm) in (("i2t", (vid, txt, vmask)), ("t2i", (txt, vid, tmask))):
            eq = focal == "equal"
            got, ms = timed(lambda: xk.direction_sim(ctx, qry, cm, 20.0, eq), reps=3)
            want, plain_ms = timed(lambda: xk.direction_sim_plain(ctx, qry, cm, 20.0, eq), reps=3)
            worst = max(worst, check_close(f"64x64 {direction} {focal}", got, want, focal))
            log(f"[kernels] 64x64 {direction} {focal}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
                f"(one 64x64 block of the plain version)")
            if float(got[1].abs().max()) != 0.0:
                fail(f"{direction} {focal}: fully masked context item must score 0")
    return worst


def _train_inputs(seed: int, n: int, length: int, d: int, device):
    """Items as a training batch holds them: every row a real vector, the
    positions past each item's length masked (-100), and item 1 masked
    throughout."""
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(n, length, d, generator=g)
    lens = torch.randint(1, length + 1, (n,), generator=g)
    mask = ((torch.arange(length)[None, :] < lens[:, None]).float() - 1.0) * 100.0
    mask[1] = -100.0
    return feats.to(device), mask.to(device)


def phase_kernels_train(device, n: int = 128, regions: int = 30, seed: int = 2) -> dict:
    """The training shapes: n x n items, D = 256, regions (Ls = `regions`:
    30 at f = 1, 240 at f = 8) and words (Lq = 99) in both directions; both
    modes, both focal types. The worst max abs error of each kernel is
    returned."""
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    reg, rmask = _train_inputs(seed, n, regions, 256, device)
    wrd, wmask = _train_inputs(seed + 1, n, 99, 256, device)
    g = torch.randn(n, n, generator=torch.Generator().manual_seed(seed + 2)).to(device)
    worst = {xk.KERNEL: 0.0, xk.KERNEL_BF16: 0.0, xk.KERNEL_DQ: 0.0, xk.KERNEL_DC: 0.0}
    for mode in ("f32", "bf16"):
        bf16 = mode == "bf16"
        r, w = (xk.round_bf16(reg), xk.round_bf16(wrd)) if bf16 else (reg, wrd)
        fwd = xk.KERNEL_BF16 if bf16 else xk.KERNEL
        for focal in ("prob", "equal"):
            eq = focal == "equal"
            tol = TOL_TRAIN[mode]
            flip = (TOL_TRAIN_FLIP, MAX_TRAIN_FLIP_SHARE) if (eq or bf16) else (0.0, 0.0)
            for direction, (ctx, qry, cm) in (("i2t", (r, w, rmask)), ("t2i", (w, r, wmask))):
                args = (ctx, qry, cm, 20.0, eq, bf16)
                tag = f"train {n}x{n} Ls={ctx.shape[1]} {direction} {focal} {mode}"
                got = xk.direction_sim(*args)
                want = xk.direction_sim_plain(*args)
                worst[fwd] = max(worst[fwd], check_rel(f"{tag} forward", got, want, tol, *flip))
                if float(got[1].abs().max()) != 0.0:
                    fail(f"{tag}: fully masked context item must score 0")
                bargs = (ctx, qry, cm, g, 20.0, eq, bf16)
                dc, dq = xk.direction_sim_bwd(*bargs)
                dc2, dq2 = xk.direction_sim_bwd(*bargs)
                pdc, pdq = xk.direction_sim_bwd_plain(*bargs)
                torch.cuda.synchronize()
                if not (torch.equal(dc, dc2) and torch.equal(dq, dq2)):
                    fail(f"{tag}: two backward runs differ (no atomics: must be bit-identical)")
                worst[xk.KERNEL_DC] = max(worst[xk.KERNEL_DC],
                                          check_rel(f"{tag} d_context", dc, pdc, tol, *flip))
                worst[xk.KERNEL_DQ] = max(worst[xk.KERNEL_DQ],
                                          check_rel(f"{tag} d_query", dq, pdq, tol, *flip))
                if float(dc[1].abs().max()) != 0.0:
                    fail(f"{tag}: a fully masked context item must get a zero gradient")
    log(f"[kernels] training shapes {n}x{n}, {regions} regions: backward kernels "
        "bit-identical on rerun in every case")
    return worst


def _attn_inputs(shape, dtype, device, seed: int):
    """q (scaled by hd^-0.5), k, v in `dtype` and an f32 bias of 0 / -100
    for one grouped-attention shape; the first key of every group (the CLS
    key) visible, and group 1 masked throughout."""
    g, lq, lk = shape
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(g, lq, 64, generator=gen) * 64 ** -0.5
    k = torch.randn(g, lk, 64, generator=gen)
    v = torch.randn(g, lk, 64, generator=gen)
    bias = ((torch.rand(g, lk, generator=gen) > 0.2).float() - 1.0) * 100.0
    bias[:, 0] = 0.0
    bias[1] = -100.0
    return [t.to(dtype).to(device) for t in (q, k, v)] + [bias.to(device)]


def phase_kernels_attention(device) -> float:
    """grouped_attention against grouped_attention_plain at the region
    tower's f = 8 shapes, f32 and bf16; returns the worst max abs error."""
    from demovlp_tpu_torch.ops import attention_kernel as ak

    worst = 0.0
    for mode, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for name, shape in ATTN_SHAPES.items():
            args = _attn_inputs(shape, dtype, device, seed=10)
            got = ak.grouped_attention(*args)
            want = ak.grouped_attention_plain(*args)
            if got.dtype != dtype:
                fail(f"grouped_attention {name} {mode}: result dtype {got.dtype}")
            worst = max(worst, check_rel(f"grouped_attention {name} G,Lq,Lk={shape} {mode}",
                                         got, want, TOL_ATTN[mode]))
    return worst


def phase_attention_op(device) -> int:
    """The kernel's op path: `grouped_attention_fused` forward (the kernel)
    and backward (recompute through the plain version) at the four tower
    shapes in bf16, the towers' type; the launch count reset just before
    and read just after."""
    from demovlp_tpu_torch.ops import attention_kernel as ak

    ak.reset_launch_counts()
    grads_ok = True
    for name, shape in ATTN_SHAPES.items():
        q, k, v, bias = _attn_inputs(shape, torch.bfloat16, device, seed=11)
        leaves = [t.requires_grad_() for t in (q, k, v)]
        out = ak.grouped_attention_fused(*leaves, bias)
        cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(12)).to(device)
        (out.float() * cot).sum().backward()
        grads_ok &= all(bool(torch.isfinite(t.grad.float()).all()) for t in leaves)
    torch.cuda.synchronize()
    launches = ak.LAUNCHES[ak.KERNEL]
    log(f"[attention-op] grouped_attention_fused forward + backward at {list(ATTN_SHAPES)}: "
        f"kernel launches {launches}")
    if launches != len(ATTN_SHAPES) or not grads_ok:
        fail(f"the op path launched the kernel {launches} times (expected "
             f"{len(ATTN_SHAPES)}) or gave non-finite gradients")
    return launches


def phase_reference(tmp: Path) -> None:
    from demovlp_tpu_torch.cli.extract_embeddings import run

    smoke = str(ROOT / "configs" / "smoke" / "synthetic_retrieval.json")
    recs = {}
    for dev in ("cuda", "cpu"):
        recs[dev] = run(["-c", smoke, "--device", dev, "--topk", "5",
                         "--output", str(tmp / f"smoke_{dev}.npz")])[0]
    for k, v in recs["cuda"]["cat"].items():
        w = recs["cpu"]["cat"][k]
        err = float(np.abs(v - w).max())
        log(f"[reference] smoke config, card vs CPU: {k} {v.shape}, max_abs_err {err:.3e}")
        # f32 towers on both, TF32 off: summation order only
        if not np.isfinite(v).all() or not np.allclose(v, w, rtol=1e-4, atol=1e-5):
            fail(f"card and CPU embeddings {k} disagree (max_abs_err {err})")
    a, b = recs["cuda"]["sims"], recs["cpu"]["sims"]
    # the sims inherit focal 'equal' threshold flips from those last-digit
    # embedding differences, so they are held as the kernel is, with room
    # for a few flipped entries of the small 32 x 32 matrix (<= 1%)
    check_close("smoke sims, card vs CPU", torch.from_numpy(a), torch.from_numpy(b),
                "equal", max_share=1e-2)
    # top-5 sets agree wherever the CPU's 5th and 6th scores are apart
    order = np.argsort(-b, axis=1)
    for q in range(b.shape[0]):
        gap = b[q, order[q, 4]] - b[q, order[q, 5]]
        if gap > 2 * TOL_FLIP and set(np.argsort(-a[q])[:5]) != set(order[q, :5]):
            fail(f"top-5 of query {q} differs between card and CPU")


def phase_serve(tmp: Path):
    from demovlp_tpu_torch.cli.extract_embeddings import run
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    torch.cuda.reset_peak_memory_stats()
    xk.reset_launch_counts()
    t0 = time.perf_counter()
    rec = run(["-c", str(SERVE_CFG), "--split", "test", "--topk", "10",
               "--output", str(tmp / "emb.npz"), "--results", str(tmp / "results.json")])[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(xk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    cat, sims, results = rec["cat"], rec["sims"], rec["results"]
    n = cat["g_t"].shape[0]
    log(f"[serve] {n} videos (f=8, k=30, bf16, full width): embed {rec['embed_s']:.3f}s "
        f"= {n / rec['embed_s']:.1f} videos/s; sims + top-10 {rec['sims_s']:.3f}s; "
        f"wall {wall:.3f}s; peak device memory {peak / 2**30:.3f} GiB")
    log(f"[serve] kernel launches in this run: {launches}")
    if launches[xk.KERNEL] < 1:
        fail("the serving path launched no xattn_sim_fwd kernel")
    if n != 1000:
        fail(f"expected 1000 gallery videos, got {n}")
    shapes = {k: v.shape for k, v in cat.items()}
    if shapes["l_o"] != (n, 240, 256) or shapes["l_t"] != (n, 99, 256) or sims.shape != (n, n):
        fail(f"unexpected shapes: {shapes}, sims {sims.shape}")
    for k, v in cat.items():
        if not np.isfinite(v).all():
            fail(f"non-finite {k}")
    if not np.isfinite(sims).all():
        fail("non-finite sims")
    if len(results) != n or any(len(r["topk_indices"]) != 10 for r in results):
        fail("top-10 results malformed")
    return cat, launches[xk.KERNEL]


def phase_bf16(tmp: Path, cat) -> None:
    """The first batch of the full-width bf16 serve, embedded again on the
    CPU from the same seeded weights and samples."""
    from demovlp_tpu_torch.cli.extract_embeddings import run

    cfg = json.loads(SERVE_CFG.read_text())
    args = cfg["data_loader"]["args"]
    n = args["batch_size"]
    args["object_params"]["num_samples"] = n
    path = tmp / "serve_first_batch.json"
    path.write_text(json.dumps(cfg))
    t0 = time.perf_counter()
    cpu = run(["-c", str(path), "--split", "test", "--device", "cpu",
               "--output", str(tmp / "emb_cpu.npz")])[0]["cat"]
    log(f"[bf16] first {n} videos of the serve on the CPU: {time.perf_counter() - t0:.1f}s")
    for k, want in cpu.items():
        got = cat[k][:n]
        if k in ("o_mask", "t_mask", "t_len"):
            if not np.array_equal(got, want):
                fail(f"card and CPU {k} differ")
            continue
        err = float(np.abs(got - want).max() / np.abs(want).max())
        log(f"[bf16] card vs CPU {k} {want.shape}: max |err| / max |value| {err:.3e} "
            f"(limit {TOL_BF16_CARD:g})")
        if not np.isfinite(got).all() or not err <= TOL_BF16_CARD:
            fail(f"card and CPU bf16 embeddings {k} disagree ({err})")


def _two_train_steps(device, cfg=None):
    """Two deterministic train steps of an f32 config (default: the smoke
    config) from the seeded init: (losses, step-1 gradients, parameters
    after step 2), on the host."""
    from demovlp_tpu_torch.cli import common
    from demovlp_tpu_torch.train.steps import (batch_to_device, make_retrieval_train_step,
                                               prepare_batch)

    cfg = cfg or json.loads(SMOKE_CFG.read_text())
    model = common.build_train_model(cfg, device, seed=0)
    opt = common.build_optimizer(cfg, model.parameters())
    step = make_retrieval_train_step(model, common.build_loss(cfg), opt, deterministic=True)
    dl = common.init_dataloaders(cfg)[0][0]
    dl.set_epoch(1)
    tok = common.build_tokenizer_from_config(cfg)
    lr = float(cfg["optimizer"]["args"]["lr"])
    losses, grads = [], None
    for _, data in zip(range(2), dl):
        m = step(batch_to_device(prepare_batch(data, tok), device), lr)
        losses.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
    params = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    return losses, grads, params, lr


def phase_train_ref(device, tag: str = "train-ref", cfg=None) -> None:
    """Two deterministic f32 train steps on the card and on the CPU."""
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    xk.reset_launch_counts()
    card = _two_train_steps(device, cfg)
    launched = dict(xk.LAUNCHES)
    cpu = _two_train_steps(torch.device("cpu"), cfg)
    if launched[xk.KERNEL_DQ] < 2 or launched[xk.KERNEL_DC] < 2:
        fail(f"{tag}: the card's train steps did not launch the backward kernels: {launched}")
    for i, (a, b) in enumerate(zip(card[0], cpu[0])):
        log(f"[{tag}] step {i + 1} losses card {a} cpu {b}")
        for k in ("loss", "global_loss", "local_loss"):
            if not np.isfinite(a[k]) or abs(a[k] - b[k]) > TRAIN_REF_LOSS_RTOL * abs(b[k]) + 1e-6:
                fail(f"{tag} step {i + 1} {k}: card {a[k]} vs cpu {b[k]}")
    worst_g = 0.0
    for name, g in card[1].items():
        w = cpu[1][name]
        err = float((g - w).abs().max())
        worst_g = max(worst_g, err)
        tol = TRAIN_REF_GRAD
        if not torch.allclose(g, w, rtol=tol["rtol"],
                              atol=tol["atol"] + tol["scale_atol"] * float(w.abs().max())):
            fail(f"{tag} step-1 gradient {name}: card vs cpu max abs err {err}")
    lr, worst_p, loose, total = card[3], 0.0, 0, 0
    tp = TRAIN_REF_PARAM
    for name, v in card[2].items():
        w = cpu[2][name]
        err = (v - w).abs()
        worst_p = max(worst_p, float(err.max()))
        if float(err.max()) > 2 * lr + tp["atol"] + tp["rtol"] * float(w.abs().max()):
            fail(f"{tag} parameter {name} after two steps: card vs cpu max abs err "
                 f"{float(err.max())}")
        loose += int((err > tp["atol"] + tp["rtol"] * w.abs()).sum())
        total += err.numel()
    log(f"[{tag}] two f32 steps: step-1 gradients max abs err {worst_g:.3e}; "
        f"parameters after step 2 max abs err {worst_p:.3e} (lr {lr:g}), share beyond "
        f"{tp['atol']:g} + {tp['rtol']:g}|p|: {loose / total:.2e}; card launches {launched}")
    if loose / total > tp["max_loose_share"]:
        fail(f"{tag}: {loose} of {total} parameters beyond the tight tolerance")


def phase_train(tmp: Path, device):
    """The train CLI at full width: one epoch of configs/bench/ab_local_bf16.json."""
    from demovlp_tpu_torch.cli import common
    from demovlp_tpu_torch.cli.train import run
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    cfg = json.loads(TRAIN_CFG.read_text())
    cfg["trainer"].update(epochs=1, save_dir=str(tmp / "train"))
    path = tmp / "train.json"
    path.write_text(json.dumps(cfg))
    init = common.build_train_model(cfg, torch.device("cpu"), seed=0).state_dict()
    torch.cuda.reset_peak_memory_stats()
    xk.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = run(["-c", str(path)], fence_steps=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(xk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    steps, losses, log_ = trainer.step_times, trainer.step_losses, trainer.final_log
    batch = trainer.data_loader[0].batch_size
    step_ms = 1e3 * float(np.median(steps[1:]))
    log(f"[train] {len(steps)} steps of {batch} (f=1, k=30, bf16, full width): median step "
        f"{step_ms:.3f} ms over steps 2-{len(steps)} (card fenced after each step), "
        f"{batch / step_ms * 1e3:.1f} pairs/s; step 1 {1e3 * steps[0]:.3f} ms; wall with "
        f"validation and checkpoint {wall:.1f}s; peak device memory {peak / 2**30:.3f} GiB")
    log(f"[train] step ms: {[round(1e3 * t, 3) for t in steps]}")
    log(f"[train] loss at step 1 {losses[0]:.6f}, at step {len(losses)} {losses[-1]:.6f}")
    log(f"[train] kernel launches in this run (train steps and validation): {launches}")
    log(f"[train] val R@1 {log_['val_0_t2v_metrics_R1']}, R@5 {log_['val_0_t2v_metrics_R5']}, "
        f"R@10 {log_['val_0_t2v_metrics_R10']} (t2v); v2t R@1 {log_['val_0_v2t_metrics_R1']}")
    if len(steps) != 16:
        fail(f"expected 16 train steps, got {len(steps)}")
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss: {losses}")
    for k in (xk.KERNEL_BF16, xk.KERNEL_DQ, xk.KERNEL_DC):
        if launches[k] < 16:
            fail(f"{k} launched {launches[k]} times in 16 train steps")
    if launches[xk.KERNEL] < 1:
        fail("validation launched no f32 forward kernel")
    final = trainer.model.state_dict()
    moved = sum(not torch.equal(final[k].cpu(), v) for k, v in init.items())
    log(f"[train] {moved} of {len(init)} parameter tensors changed in the epoch")
    if moved == 0:
        fail("the parameters did not change in the epoch")
    return trainer, launches


def _first_batch_local(trainer):
    """The local embeddings and masks of a train run's first batch (f32)."""
    from demovlp_tpu_torch.ops.masking import additive_mask
    from demovlp_tpu_torch.train.steps import batch_to_device, prepare_batch

    dl = trainer.data_loader[0]
    dl.set_epoch(1)
    data = next(iter(dl))
    batch = batch_to_device(prepare_batch(data, trainer.tokenizer), trainer.device,
                            trainer.transfer_dtype)
    with torch.no_grad():
        trainer.model.eval()
        out = trainer.model(batch)
    return dict(l_o=out["local_object_embeddings"].float().contiguous(),
                l_t=out["local_text_embeddings"].float().contiguous(),
                o_mask=out["object_mask"].float().contiguous(),
                t_mask=additive_mask(batch["attention_mask"][:, 1:]).contiguous())


def phase_train_local(trainer):
    """The first batch of the full-width run: the local loss and its
    gradients with respect to both local embeddings, through the kernels and
    through the plain versions (swapped in for the kernel wrappers), both on
    the card."""
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    inputs = _first_batch_local(trainer)
    local = trainer.loss.local_loss
    lam, eq = local.lambda_softmax, local.focal_type == "equal"
    o_mask, t_mask = inputs["o_mask"], inputs["t_mask"]

    def leaves():
        return (inputs["l_o"].clone().requires_grad_(), inputs["l_t"].clone().requires_grad_())

    def run_path():
        """(loss, d l_o, d l_t) through the loss; each direction's share of
        (d l_o, d l_t) for the loss's own cotangent g on the scores; and the
        same shares for |g|, which add up the terms of the sums over the
        other side without their cancellation."""
        l_o, l_t = leaves()
        loss = local(l_o, l_t, o_mask, None, t_mask)
        loss.backward()
        with torch.no_grad():
            scores = xk.xattn_score_kernel(l_o, l_t, o_mask, t_mask, lam, local.focal_type,
                                           torch.bfloat16)
        s_ = scores.clone().requires_grad_()
        logits = s_ * lam
        eye = torch.eye(s_.shape[0], device=s_.device)
        kl = torch.mean(torch.sum(torch.softmax(logits, 1) * (
            torch.log_softmax(logits, 1) - torch.log(eye + 1e-6)), 1))
        (g,) = torch.autograd.grad(kl, s_)
        shares = {}
        for key, cot in (("", g), ("abs ", g.abs())):
            a_o, a_t = leaves()
            i2t = xk.differentiable_direction_sim(a_o, a_t, o_mask, lam, eq, True)
            shares[key + "i2t"] = torch.autograd.grad((i2t * cot).sum(), (a_o, a_t))
            b_o, b_t = leaves()
            t2i = xk.differentiable_direction_sim(b_t, b_o, t_mask, lam, eq, True)
            shares[key + "t2i"] = torch.autograd.grad((t2i * cot.T).sum(), (b_o, b_t))
        return loss.detach(), (l_o.grad, l_t.grad), shares

    xk.reset_launch_counts()
    k_loss, k_grads, k_shares = run_path()
    kernel_launches = dict(xk.LAUNCHES)
    saved = xk.direction_sim, xk.direction_sim_bwd
    xk.direction_sim, xk.direction_sim_bwd = xk.direction_sim_plain, xk.direction_sim_bwd_plain
    try:
        xk.reset_launch_counts()
        p_loss, p_grads, p_shares = run_path()
        plain_launches = dict(xk.LAUNCHES)
    finally:
        xk.direction_sim, xk.direction_sim_bwd = saved
    log(f"[train-local] first batch {tuple(inputs['l_o'].shape)} regions, "
        f"{tuple(inputs['l_t'].shape)} words, local_dtype {local.local_dtype}, focal "
        f"{local.focal_type}: loss kernels {float(k_loss):.6f}, plain {float(p_loss):.6f}; "
        f"launches {kernel_launches} (kernels), {plain_launches} (plain)")
    if any(plain_launches.values()) or min(
            kernel_launches[k] for k in (xk.KERNEL_BF16, xk.KERNEL_DQ, xk.KERNEL_DC)) < 2:
        fail("the kernel and plain local losses did not take their own paths")
    if not torch.isfinite(k_loss) or abs(float(k_loss - p_loss)) > TRAIN_LOCAL_LOSS_RTOL * abs(
            float(p_loss)):
        fail(f"local loss: kernels {float(k_loss)} vs plain {float(p_loss)}")
    tol = TOL_TRAIN["bf16"]
    for i, name in enumerate(("d local_object", "d local_text")):
        scales = {d: float(p_shares["abs " + d][i].abs().max()) for d in ("i2t", "t2i")}
        for d in ("i2t", "t2i"):
            log(f"[train-local] {name}, {d} share: max |share| {float(p_shares[d][i].abs().max()):.3e}, "
                f"with |g| {scales[d]:.3e}")
            check_rel(f"full-width local loss {name}, {d} share", k_shares[d][i],
                      p_shares[d][i], tol, TOL_TRAIN_FLIP, MAX_TRAIN_FLIP_SHARE, scales[d])
        check_rel(f"full-width local loss {name}", k_grads[i], p_grads[i], 2 * tol,
                  TOL_TRAIN_FLIP, MAX_TRAIN_FLIP_SHARE, max(scales.values()))
    return inputs


def _narrow_f8_config(tmp: Path) -> dict:
    """The f32 smoke config at f = 8 x k = 30 with D = 256 local embeddings
    (narrow towers), starting from an f = 1 checkpoint of the same model
    whose temporal embed is not zero; "bilinear" inflation."""
    from demovlp_tpu_torch.cli import common

    cfg = json.loads(SMOKE_CFG.read_text())
    args = cfg["arch"]["args"]
    args["projection_dim"] = 256
    for obj_p in (args["object_params"], cfg["data_loader"]["args"]["object_params"]):
        obj_p.update(num_frames=8, object_num=30)
    f1 = json.loads(json.dumps(cfg))
    f1["arch"]["args"]["object_params"]["num_frames"] = 1
    model = common.build_model(f1)
    gen = torch.Generator().manual_seed(7)
    model.reset_parameters(gen)
    with torch.no_grad():
        model.object_model.temporal_embed.normal_(0.0, 0.02, generator=gen)
    path = tmp / "narrow_f1.pth"
    torch.save({"state_dict": model.state_dict()}, path)
    args.update(load_checkpoint=str(path), load_temporal_fix="bilinear")
    return cfg


def phase_finetune(tmp: Path, device, pretrain):
    """The train CLI at full width on configs/bench/ft_synthetic_f8.json,
    starting from the train phase's f = 1 checkpoint."""
    from demovlp_tpu_torch.cli import common
    from demovlp_tpu_torch.cli.train import run
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    ckpt = pretrain.checkpoint.save_dir / "checkpoint-epoch1.pth"
    cfg = json.loads(FT_CFG.read_text())
    cfg["arch"]["args"]["load_checkpoint"] = str(ckpt)
    cfg["trainer"]["save_dir"] = str(tmp / "finetune")
    path = tmp / "finetune.json"
    path.write_text(json.dumps(cfg))
    f1 = torch.load(ckpt, map_location="cpu", weights_only=True)["state_dict"][
        "object_model.temporal_embed"]
    start = common.build_train_model(cfg, torch.device("cpu"), seed=0)
    embed = start.object_model.temporal_embed.detach()
    del start
    log(f"[finetune] f = 1 checkpoint {tuple(f1.shape)} temporal embed -> {tuple(embed.shape)} "
        f"(zeros), |frame 0| {float(embed[0, 0].norm()):.4f}")
    if (embed.shape != (1, 8, f1.shape[-1]) or not torch.equal(embed[:, :1], f1)
            or float(embed[:, 1:].abs().max()) != 0.0):
        fail("the f = 1 temporal embed was not inflated to 8 frames as 'zeros' says")
    torch.cuda.reset_peak_memory_stats()
    xk.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = run(["-c", str(path)], fence_steps=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(xk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    steps, losses, log_ = trainer.step_times, trainer.step_losses, trainer.final_log
    batch = trainer.data_loader[0].batch_size
    step_ms = 1e3 * float(np.median(steps[1:]))
    log(f"[finetune] {len(steps)} steps of {batch} (f=8, k=30, bf16 towers, f32 local loss, "
        f"full width, from the f = 1 checkpoint): median step {step_ms:.3f} ms over steps "
        f"2-{len(steps)} (card fenced after each step), {batch / step_ms * 1e3:.1f} pairs/s; "
        f"step 1 {1e3 * steps[0]:.3f} ms; wall with validation and checkpoint {wall:.1f}s; "
        f"peak device memory {peak / 2**30:.3f} GiB")
    log(f"[finetune] step ms: {[round(1e3 * t, 3) for t in steps]}")
    log(f"[finetune] loss at step 1 {losses[0]:.6f}, at step {len(losses)} {losses[-1]:.6f}")
    log(f"[finetune] kernel launches in this run (train steps and validation): {launches}")
    log(f"[finetune] val R@1 {log_['val_0_t2v_metrics_R1']}, R@5 "
        f"{log_['val_0_t2v_metrics_R5']}, R@10 {log_['val_0_t2v_metrics_R10']} (t2v); v2t R@1 "
        f"{log_['val_0_v2t_metrics_R1']}")
    if len(steps) != 16:
        fail(f"expected 16 fine-tune steps, got {len(steps)}")
    if not all(np.isfinite(losses)):
        fail(f"non-finite fine-tune loss: {losses}")
    for k in (xk.KERNEL, xk.KERNEL_DQ, xk.KERNEL_DC):
        if launches[k] < 32:
            fail(f"{k} launched {launches[k]} times in 16 fine-tune steps (2 a step expected)")
    return trainer, launches


def _two_qa_steps(device):
    """Two deterministic QA train steps of the f32 smoke config from the
    seeded init: (losses, the first batch's logits after them)."""
    from demovlp_tpu_torch.cli import common
    from demovlp_tpu_torch.train.steps import batch_to_device, make_qa_train_step, prepare_batch

    cfg = json.loads(SMOKE_QA_CFG.read_text())
    model = common.build_train_model(cfg, device, seed=0)
    opt = common.build_optimizer(cfg, model.parameters())
    step = make_qa_train_step(model, common.build_loss(cfg), opt, deterministic=True)
    dl = common.init_dataloaders(cfg, val_split="test")[0][0]
    dl.set_epoch(1)
    tok = common.build_tokenizer_from_config(cfg)
    lr = float(cfg["optimizer"]["args"]["lr"])
    batches = [batch_to_device(prepare_batch(d, tok), device) for _, d in zip(range(2), dl)]
    losses = [float(step(b, lr)["loss"]) for b in batches]
    with torch.no_grad():
        model.eval()
        logits = model(batches[0])["logits"].cpu()
    return losses, logits


def phase_qa(tmp: Path, device) -> None:
    """train_qa at full width on configs/bench/qa_synthetic_f8.json, then
    card vs CPU on the smoke config."""
    from demovlp_tpu_torch.cli.train_qa import run

    cfg = json.loads(QA_CFG.read_text())
    cfg["trainer"]["save_dir"] = str(tmp / "qa")
    path = tmp / "qa.json"
    path.write_text(json.dumps(cfg))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = run(["-c", str(path)], fence_steps=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps, losses, log_ = trainer.step_times, trainer.step_losses, trainer.final_log
    batch = trainer.data_loader[0].batch_size
    step_ms = 1e3 * float(np.median(steps[1:]))
    log(f"[qa] {len(steps)} steps of {batch} (f=8, k=30, bf16, full width, 1500 answers): "
        f"median step {step_ms:.3f} ms over steps 2-{len(steps)} (card fenced after each step), "
        f"{batch / step_ms * 1e3:.1f} questions/s; wall with validation and checkpoint "
        f"{wall:.1f}s; peak device memory {peak / 2**30:.3f} GiB")
    log(f"[qa] loss at step 1 {losses[0]:.6f}, at step {len(losses)} {losses[-1]:.6f}; "
        f"train acc {log_['train_acc']}, val overall acc {log_['val_0_evaluate_qa_overall_acc']}")
    if len(steps) != 16 or not all(np.isfinite(losses)):
        fail(f"QA: expected 16 finite steps, got {losses}")
    del trainer
    card, cpu = _two_qa_steps(device), _two_qa_steps(torch.device("cpu"))
    err = float((card[1] - cpu[1]).abs().max())
    log(f"[qa] smoke config, two f32 steps: losses card {card[0]} cpu {cpu[0]}; logits after "
        f"them max abs err {err:.3e}")
    for a, b in zip(card[0], cpu[0]):
        if not np.isfinite(a) or abs(a - b) > TRAIN_REF_LOSS_RTOL * abs(b) + 1e-6:
            fail(f"QA loss card {a} vs cpu {b}")
    if not torch.allclose(card[1], cpu[1], **QA_LOGITS_TOL):
        fail(f"QA logits after two steps: card vs cpu max abs err {err}")


def _mc_scores(device, n_items: int = 8):
    """The option scores of the smoke MC config's first items, one batched
    call, from the seeded init."""
    from demovlp_tpu_torch.cli import common
    from demovlp_tpu_torch.train.steps import (batch_to_device, make_mc_eval_step_batched,
                                               prepare_batch)

    cfg = json.loads(SMOKE_MC_CFG.read_text())
    model = common.build_train_model(cfg, device, seed=0)
    step = make_mc_eval_step_batched(model, common.build_loss(cfg))
    tok = common.build_tokenizer_from_config(cfg)
    items = []
    for _, data in zip(range(n_items), common.init_dataloaders(cfg, val_split="test")[1][0]):
        arrays = prepare_batch(data, tok)
        n_opt = arrays["input_ids"].shape[0]
        arrays["object"] = np.repeat(data["object"], n_opt, axis=0)
        arrays["object_mask"] = np.repeat(data["object_mask"], n_opt, axis=0)
        items.append(arrays)
    keys = ("input_ids", "attention_mask", "object", "object_mask")
    batch = {k: np.stack([a[k] for a in items]) for k in keys}
    return step(batch_to_device(batch, device)).cpu()


def phase_mc(tmp: Path, device) -> int:
    """train_mc at full width on configs/bench/mc_synthetic_f8.json (the
    f32 forward kernel scores the local part), then card vs CPU on the
    smoke config."""
    from demovlp_tpu_torch.cli.train_mc import run
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    cfg = json.loads(MC_CFG.read_text())
    cfg["trainer"]["save_dir"] = str(tmp / "mc")
    path = tmp / "mc.json"
    path.write_text(json.dumps(cfg))
    torch.cuda.reset_peak_memory_stats()
    xk.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = run(["-c", str(path)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(xk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n = len(trainer.valid_data_loader[0].dataset)
    log(f"[mc] {n} items x 5 options (f=8, k=30, bf16, full width), {trainer.mc_eval_batch} "
        f"items a call: {wall:.2f}s = {n / wall:.1f} items/s; peak device memory "
        f"{peak / 2**30:.3f} GiB; accuracy {trainer.final_log['val_0_evaluate_mc_mc_accuracy']}%; "
        f"kernel launches {launches}")
    calls = -(-n // trainer.mc_eval_batch)
    if launches[xk.KERNEL] != 2 * calls:
        fail(f"MC launched the f32 forward kernel {launches[xk.KERNEL]} times, expected "
             f"{2 * calls} (two directions a call)")
    del trainer
    card, cpu = _mc_scores(device), _mc_scores(torch.device("cpu"))
    check_close("mc smoke scores, card vs CPU", card, cpu, "equal", max_share=1e-2)
    return launches[xk.KERNEL]


def _bound(flops: float, nbytes: float, peak: float):
    op_ms, byte_ms = 1e3 * flops / peak, 1e3 * nbytes / PEAK_BYTES
    return max(op_ms, byte_ms), ("operations" if op_ms >= byte_ms else "bytes")


def phase_timing_train(inputs, focal_equal: bool, bf16: bool, tag: str, device):
    """The forward and the two backward kernels on a train run's first
    batch's local embeddings (rounded to bf16 in bf16 mode, as the loss
    rounds them), with a seeded cotangent; per train step each runs once a
    direction. Rows keyed by kernel name."""
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    rnd = xk.round_bf16 if bf16 else (lambda t: t)
    l_o, l_t = rnd(inputs["l_o"]), rnd(inputs["l_t"])
    o_m, t_m = inputs["o_mask"], inputs["t_mask"]
    eq = focal_equal
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
    fwd = xk.KERNEL_BF16 if bf16 else xk.KERNEL
    g = torch.randn(l_o.shape[0], l_t.shape[0],
                    generator=torch.Generator().manual_seed(5)).to(device)
    rows = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0) for k in
            (fwd, xk.KERNEL_DQ, xk.KERNEL_DC)}
    for direction, (ctx, qry, cm, gd) in (("i2t", (l_o, l_t, o_m, g)),
                                          ("t2i", (l_t, l_o, t_m, g.T.contiguous()))):
        bc, ls, d = ctx.shape
        bq, lq, _ = qry.shape
        unit = 1.0 * bc * bq * lq * ls * d  # one multiply-add over every (c, q, l, s, d) is 2 units
        in_bytes = 4.0 * (bc * ls * d + bq * lq * d + bc * ls)
        _, fwd_ms = timed(lambda: xk.direction_sim(ctx, qry, cm, 20.0, eq, bf16), reps=5)
        _, fwd_plain = timed(lambda: xk.direction_sim_plain(ctx, qry, cm, 20.0, eq, bf16), reps=3)
        bargs = (ctx, qry, cm, gd, 20.0, eq, bf16)
        _, dq_ms = timed(lambda: xk._launch_bwd(xk.KERNEL_DQ, *bargs), reps=5)
        _, dc_ms = timed(lambda: xk._launch_bwd(xk.KERNEL_DC, *bargs), reps=5)
        _, bwd_plain = timed(lambda: xk.direction_sim_bwd_plain(*bargs), reps=3)
        # forward: 4 units (two products); backward: 12 units counted once,
        # the recomputed forward and dph (6) with dqn (2) under d_query, dcn
        # (4) under d_context
        work = {fwd: (4 * unit, in_bytes + 4.0 * bc * bq, fwd_ms, fwd_plain),
                xk.KERNEL_DQ: (8 * unit, in_bytes + 4.0 * (bc * bq + bq * lq * d), dq_ms,
                               bwd_plain),
                xk.KERNEL_DC: (4 * unit, in_bytes + 4.0 * (bc * bq + bc * ls * d), dc_ms,
                               bwd_plain)}
        for name, (flops, nbytes, ms, plain_ms) in work.items():
            bound_ms, by = _bound(flops, nbytes, peak)
            rows[name]["ms"] += ms
            rows[name]["plain_ms"] += plain_ms
            rows[name]["bound_ms"] += bound_ms
            rows[name]["bound_by"] = by
            log(f"[timing] {tag} {name} {direction} {bc}x{bq} Ls={ls} Lq={lq} D={d}: kernel "
                f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {by} "
                f"({flops:.3e} flop at {peak:.3g}/s, {nbytes:.3e} B), "
                f"{flops / ms / 1e9:.2f} TFLOP/s achieved")
    for name, r in rows.items():
        log(f"[timing] {tag} {name}: {r['ms']:.3f} ms per step (two launches, "
            f"{r['ms'] / 2:.3f} ms per launch), plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}")
    log("[timing] the plain backward computes d_context and d_query together: its time "
        "stands beside both backward kernels")
    return rows


def timed_rotating(fn, args_list, reps: int) -> float:
    """ms per call with CUDA events, each call on the next of several input
    copies (together over twice the 50 MB L2), so every call reads its
    inputs from device memory, as a layer of the tower does."""
    fn(*args_list[0])
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*args_list[i % len(args_list)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_timing_attention(device) -> dict:
    """grouped_attention in bf16 at the four tower shapes (one layer of the
    region tower at f = 8, batch 32): kernel, plain version and one
    PyTorch call computing the same function,
    scaled_dot_product_attention(q, k, v, attn_mask=bias[:, None, :],
    scale=1.0), whose mask is given in q's type (bf16 holds 0 and -100
    exactly); each beside the card's bound."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from demovlp_tpu_torch.ops import attention_kernel as ak

    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, bound_by="bytes")
    worst_bound = 0.0
    for name, shape in ATTN_SHAPES.items():
        g, lq, lk = shape
        hd = 64
        per_call = 2.0 * (2 * g * lq * hd + 2 * g * lk * hd) + 4.0 * g * lk
        copies = max(2, int(np.ceil(2 * 50e6 / per_call)))
        args = [_attn_inputs(shape, torch.bfloat16, device, seed=20 + i) for i in range(copies)]
        masked = [(q, k, v, b[:, None, :].to(q.dtype)) for q, k, v, b in args]
        ms = timed_rotating(ak.grouped_attention, args, reps=20)
        plain_ms = timed_rotating(ak.grouped_attention_plain, args, reps=5)
        lib_ms = timed_rotating(lambda q, k, v, m: sdpa(q, k, v, attn_mask=m, scale=1.0),
                                masked, reps=20)
        q, k, v, m = masked[0]
        lib_err = float((sdpa(q, k, v, attn_mask=m, scale=1.0).float()
                         - ak.grouped_attention_plain(*args[0]).float()).abs().max())
        flops = 4.0 * g * lq * lk * hd
        bound_ms, by = _bound(flops, per_call, PEAK_BF16_FLOPS)
        log(f"[timing] grouped_attention {name} G={g} Lq={lq} Lk={lk} hd={hd} bf16: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, scaled_dot_product_attention {lib_ms:.4f} ms "
            f"(max |diff| to plain {lib_err:.2e}), bound {bound_ms:.4f} ms by {by} "
            f"({flops:.3e} flop, {per_call:.3e} B, {copies} input copies rotated), "
            f"{per_call / ms / 1e6:.1f} GB/s achieved")
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        total["bound_ms"] += bound_ms
        total["library_ms"] += lib_ms
        if bound_ms > worst_bound:
            worst_bound, total["bound_by"] = bound_ms, by
    log(f"[timing] grouped_attention, one tower layer's four shapes: kernel {total['ms']:.4f} "
        f"ms, plain {total['plain_ms']:.4f} ms, scaled_dot_product_attention "
        f"{total['library_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms")
    return total


def phase_step_split(trainer, device, tag: str) -> None:
    """One more train step of a full-width retrieval run (`tag`: train or
    finetune), split with CUDA events: towers forward, losses forward
    (global + local kernels), backward (towers and the local backward
    kernels), optimizer; then the device time of one more step by kernel."""
    from demovlp_tpu_torch.train.steps import batch_to_device, prepare_batch, retrieval_losses

    dl = trainer.data_loader[0]
    dl.set_epoch(2)
    data = next(iter(dl))
    batch = batch_to_device(prepare_batch(data, trainer.tokenizer), trainer.device,
                            trainer.transfer_dtype)
    model, opt = trainer.model, trainer.optimizer

    def one_step(ev):
        model.train()
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        out = model(batch)
        ev[1].record()
        total, _, _ = retrieval_losses(trainer.loss, out, batch)
        ev[2].record()
        total.backward()
        ev[3].record()
        opt.step()
        ev[4].record()
        torch.cuda.synchronize()

    splits = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        one_step(ev)
        splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)])
    a = splits[-1]
    log(f"[timing] {tag}: one full-width step (third of three, CUDA events): towers forward "
        f"{a[0]:.3f} ms, losses forward {a[1]:.3f} ms, backward {a[2]:.3f} ms, optimizer "
        f"{a[3]:.3f} ms, total {sum(a):.3f} ms; all three: {[[round(x, 3) for x in s] for s in splits]}")
    # device time by kernel over one more step
    from torch.profiler import ProfilerActivity, profile

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one_step(ev)
    wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        # kernels only: an operator's row repeats its kernels' time
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows)
    if dev_ms <= 0.0:
        fail(f"{tag}: the profiler recorded no device time for a step")
    groups = {"local-loss kernels": 0.0, "optimizer (foreach)": 0.0, "other": 0.0}
    for ms, _, key in rows:
        k = key.lower()
        if "xattn" in k or "l2norm_rows" in k:
            groups["local-loss kernels"] += ms
        elif "foreach" in k or "multi_tensor" in k:
            groups["optimizer (foreach)"] += ms
        else:
            groups["other"] += ms
    log(f"[timing] {tag} profiler, one step: device time {dev_ms:.3f} ms of {wall_ms:.3f} ms wall "
        f"(profiled; busy share {dev_ms / wall_ms:.3f}); by group "
        f"{ {k: round(v, 3) for k, v in groups.items()} }")
    for ms, count, key in rows[:15]:
        log(f"[timing]   {ms:9.3f} ms  x{count:<4d} {key[:110]}")


def phase_timing(cat, device):
    """Kernel and plain version on the main path's own local-sims inputs."""
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    l_o = torch.from_numpy(cat["l_o"]).float().contiguous().to(device)
    l_t = torch.from_numpy(cat["l_t"]).float().contiguous().to(device)
    o_m = torch.from_numpy(cat["o_mask"]).float().contiguous().to(device)
    t_m = torch.from_numpy(cat["t_mask"]).float().contiguous().to(device)
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0)
    for direction, (ctx, qry, cm) in (("i2t", (l_o, l_t, o_m)), ("t2i", (l_t, l_o, t_m))):
        bc, ls, d = ctx.shape
        bq, lq, _ = qry.shape
        got, ms = timed(lambda: xk.direction_sim(ctx, qry, cm, 20.0, True), reps=3)
        want, plain_ms = timed(lambda: xk.direction_sim_plain(ctx, qry, cm, 20.0, True), reps=1)
        flops = 4.0 * bc * bq * lq * ls * d
        nbytes = 4.0 * (bc * ls * d + bq * lq * d + bc * ls + bc * bq)
        op_ms, byte_ms = 1e3 * flops / PEAK_F32_FLOPS, 1e3 * nbytes / PEAK_BYTES
        bound_ms = max(op_ms, byte_ms)
        total["bound_by"] = "operations" if op_ms >= byte_ms else "bytes"
        err = check_close(f"{bc}x{bq} {direction} equal (main path inputs)", got, want, "equal")
        log(f"[timing] {direction} {bc}x{bq} Ls={ls} Lq={lq} D={d}: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({flops:.3e} flop at "
            f"{PEAK_F32_FLOPS:.3g}/s: {op_ms:.3f} ms; {nbytes:.3e} B at {PEAK_BYTES:.2e} B/s: "
            f"{byte_ms:.3f} ms), {flops / ms / 1e9:.2f} TFLOP/s achieved")
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        total["bound_ms"] += bound_ms
        total["err"] = max(total["err"], err)
    return total


def main() -> None:
    kind = phase_device()
    from demovlp_tpu_torch.device import resolve_device
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    device = resolve_device("cuda")  # also turns TF32 off
    phase_build()
    err_small = phase_kernels(device)
    err_train = phase_kernels_train(device)
    err_f8 = phase_kernels_train(device, n=32, regions=240, seed=30)
    err_attn = phase_kernels_attention(device)
    attn_launches = phase_attention_op(device)
    out_dir = ROOT / "chiprun_out" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp = Path(tmp)
        phase_reference(tmp)
        cat, serve_launches = phase_serve(tmp)
        phase_bf16(tmp, cat)
        phase_train_ref(device)
        trainer, train_launches = phase_train(tmp, device)
        phase_train_ref(device, "finetune-ref", _narrow_f8_config(tmp))
        ft_trainer, ft_launches = phase_finetune(tmp, device, trainer)
        phase_qa(tmp, device)
        phase_mc(tmp, device)
    inputs = phase_train_local(trainer)
    t = phase_timing(cat, device)
    tt = phase_timing_train(inputs, trainer.loss.local_loss.focal_type == "equal", True, "train",
                            device)
    ft_local = ft_trainer.loss.local_loss
    tf8 = phase_timing_train(_first_batch_local(ft_trainer), ft_local.focal_type == "equal",
                             ft_local.local_dtype == "bfloat16", "finetune f=8", device)
    ta = phase_timing_attention(device)
    phase_step_split(trainer, device, "train")
    phase_step_split(ft_trainer, device, "finetune f=8")
    src = "demovlp_tpu_torch/csrc/"
    kernels = [{
        "name": "xattn_sim_fwd",
        "route": "cuda",
        "source": src + "xattn_sim_fwd.cu",
        # one count per direction runs three __global__ kernels
        "launch": "l2norm_rows_kernel (context rows), l2norm_rows_kernel "
                  "(query rows), xattn_sim_fwd_kernel<false>",
        "replaces": "demovlp_tpu/ops/pallas_xattn.py:91",
        "launches": serve_launches,
        "max_abs_err": max(err_small, t["err"]),
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
    }]
    sources = {xk.KERNEL_BF16: ("xattn_sim_fwd.cu", "xattn_sim_fwd_kernel<true>",
                                "demovlp_tpu/ops/pallas_xattn.py:91 (mxu_bf16 mode)"),
               xk.KERNEL_DQ: ("xattn_sim_bwd.cu", "xattn_sim_bwd_dq_kernel",
                              "demovlp_tpu/ops/pallas_xattn.py:373"),
               xk.KERNEL_DC: ("xattn_sim_bwd.cu", "xattn_sim_bwd_dc_kernel",
                              "demovlp_tpu/ops/pallas_xattn.py:413")}
    for name, (file, main_kernel, replaces) in sources.items():
        for suffix, rows, launches, errs in (("", tt, train_launches, err_train),
                                             ("_f8", tf8, ft_launches, err_f8)):
            if name not in rows:  # the f = 8 run's forward is the f32 mode
                continue
            r = rows[name]
            kernels.append({
                "name": name + suffix,
                "route": "cuda",
                "source": src + file,
                "launch": "l2norm_rows_kernel (context rows), l2norm_rows_kernel "
                          f"(query rows), {main_kernel}",
                "replaces": replaces,
                "launches": launches[name],
                "max_abs_err": errs[name],
                "ms": r["ms"],
                "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                "library_ms": None,
            })
    kernels.append({
        "name": "grouped_attention",
        "route": "cuda",
        "source": src + "grouped_attention.cu",
        "launch": "grouped_attention_kernel<__nv_bfloat16>",
        "replaces": "demovlp_tpu/ops/pallas_attention.py:28",
        "launches": attn_launches,
        "max_abs_err": err_attn,
        "ms": ta["ms"],
        "plain_ms": ta["plain_ms"],
        "bound_ms": ta["bound_ms"],
        "bound_by": ta["bound_by"],
        "library_ms": ta["library_ms"],
    })
    log("[timing] xattn_sim_fwd: ms, plain_ms and bound_ms are one serve's local sims "
        "(both directions, 1000x1000 gallery), launches those of the serve; the bf16 forward "
        "and the backward kernels: one train step's two launches at 128x128 (f = 1), launches "
        "those of the 16-step train run; the _f8 backward rows: one fine-tune step's two "
        "launches at 32x32 (f = 8, f32 mode), launches those of the 16-step fine-tune run; "
        "max_abs_err of the training kernels is the worst of the training-shape checks; the "
        "row-norm kernel's time is included in ms; no single PyTorch call computes the local "
        "similarity, so its library_ms is null. grouped_attention: ms, plain_ms, bound_ms and "
        "library_ms (scaled_dot_product_attention) summed over one tower layer's four grouped "
        "shapes in bf16; launches those of the attention-op phase")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
