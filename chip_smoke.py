#!/usr/bin/env python3
"""Build and run the PyTorch port (demovlp_tpu_torch) on one CUDA card.

    python3 chip_smoke.py                                      # one card
    torchrun --nproc-per-node 4 chip_smoke.py --torchrun       # four cards

Phases, each fatal on failure (exit code != 0, and no result line):
  1. device   — needs a CUDA card; prints its name and power limit;
  2. build    — nvcc for sm_90a on every csrc/*.cu, all in parallel, with
                the ptxas register / shared-memory summary;
  3. kernels  — each kernel against its plain PyTorch version: the f32
                forward at serving widths (D=256, 240 regions, 99 words),
                then at the training shapes (128 x 128 items, D=256,
                (Ls, Lq) = (30, 99) and (99, 30)) the forward in both modes
                (f32: xattn_sim_fwd_tf32_kernel; bf16:
                xattn_sim_fwd_bf16_kernel, bf16 tensor-core tiles, several
                pairs a block) and the two backward kernels in both modes,
                each bf16 forward and each backward run twice and required
                bit-identical; both directions, both focal types, padded and
                fully masked items included; then the -fast pre-training's
                text-bucket shapes (128 x 128 items, (Ls, Lq) = (30, 31),
                (31, 30), (30, 47), (47, 30), (30, 63), (63, 30)): every
                kernel in both modes against its plain version, each run
                twice and held bit-identical (the f32 forward too), with the
                S the launchers chose printed; in f32 'prob' a backward
                entry may exceed the tight tolerance only in a row with a
                leaky-ReLU kink pair, and there only by what that pair's
                slope flip can move it (kink_bounds);
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
  6b. query   — the query CLI at full width (the serve's seeded weights)
                against the index the serve wrote: 64 queries (60 gallery
                captions, 4 free-text) x 1000 videos, then one query; the
                f32 forward launched twice a call (launch counts reset just
                before); the gallery captions' text embeddings against the
                serve's rows, and on a 100-video slice the card's
                query_retrieval against the CPU's and the card's scoring
                against the CPU's on the same embeddings; the single query's
                scoring over the whole gallery, card against CPU, and the
                CLI's single-query sims against it;
  7. train-ref — two deterministic train steps of the f32 smoke config on
                the card and on the CPU from the same weights and batches:
                losses, step-1 gradients and parameters must agree;
  8. train    — the train CLI at full width on configs/bench/ab_local_bf16.json
                (f=1 x k=30, batch 128, bf16 towers and local loss, one
                epoch = 16 steps, then validation over the val split), the
                launch counts reset just before and read just after;
  8a. record — the train run's record under <save_dir>/log/<name>/<stamp>/:
                scalars.jsonl holds train/loss_train_0 at steps 1-16 equal to
                the trainer's losses and loss_val_0 after validation,
                info.log the epoch log, and web/<name>/<stamp>/ exists; then
                the same 16 steps (epoch 1's batches) with the writer and
                without it, fenced: the medians with their spread, and the
                synchronising calls torch's sync debug mode reports in each
                loop, which must be equal;
  8b. profile — (run after the timings, 14) utils/profiling.trace over 6
                unfenced steps of that trainer,
                twice: with its loader drawing batches during the window,
                then with the batches drawn before it; the loop's
                pieces in annotate spans
                (data, prepare, to_device, step, consume): each span's mean
                host ms, the 10 host ops with the most self CPU time, the 10
                device kernels with the most time, the device's busy share
                over the window and its 5 longest idle gaps with the span
                the host was in; the traces, gzipped, under
                chiprun_out/chip_smoke/profile{,-loader-idle}/;
  8c. pretrain-fast — the train CLI at full width on
                configs/bench/ab_local_bf16_fast.json (the -fast path: long-tail
                captions, length-grouped batches, text trimmed to 32 / 48 / 64;
                16 steps, then validation), launch counts reset just before and
                read just after, by kernel and by (Ls, Lq): every step's text
                length must be the one worked out on the host before the run
                (FAST_EPOCH1_LENGTHS, from the CPU), at least two lengths, 16
                finite losses; each step's length and fenced ms, the median a
                bucket, peak memory, [train]'s median beside it;
  8d. mlm     — train-ref with mlm.weight 0.5 and text buckets (masks drawn
                on the host as the trainer draws them), then 4 full-width
                steps of the -fast config with mlm.weight 0.5;
  8e. remat   — one full-width step of ab_local_bf16.json with and without
                remat from the same weights, batch and dropout key: the
                losses and the region tower's gradients agree, the peak
                memory of each printed;
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
 11b. realdata — the train CLI on configs/ft/msvd_o2t-select.json (text tower
                random-init at full width, from the train phase's f = 1
                checkpoint, 16 steps of 32 at f = 8, validation before and after)
                over real MSVD ids and captions (the first 512 rows of
                meta_data/MSVD_train.tsv, 256 of MSVD_test.tsv) and a region
                tree written from a seed under build/ (8-12 frames a video,
                10-36 regions a frame, one file in eight compressed; about
                1.5 GB, removed after the phase), through MSVDObjectSelect and
                the native reader (demovlp_tpu_torch/native, built by g++ into
                build/native/) decoding whole batches; launch counts and the
                reader's frame counts reset just before and read just after;
                fails unless every train and validation frame was decoded
                natively. Then a step with its data (real vs synthetic), and
                the loader alone through the native and the numpy per-sample
                paths, whose batches must be identical;
 12. qa       — train_qa at full width on configs/bench/qa_synthetic_f8.json
                (batch 64, 1500 answers, 16 steps, a val pass); card vs CPU
                on the f32 smoke config: losses and logits of two steps;
 12b. predict-qa — the predict CLI with the qa run's checkpoint over
                qa_synthetic_f8.json's test split: the predictions equal the
                argmax of the QA trainer's own eval logits; questions/s;
 13. mc       — train_mc at full width on configs/bench/mc_synthetic_f8.json
                (256 items, 5 options, 8 items a call); card vs CPU on the
                smoke config: the option scores;
 13b. extractor — PatchRegionExtractor at its default widths (384 x 6 layers x
                6 heads, patch 16) on seeded 224 x 224 frames, f = 8, k = 30,
                64 videos in batches of 16 in the serve config's bf16; card vs
                CPU on one batch in f32 with the same weights (object within
                1e-4 of its largest entry and conf within 1e-6, regions
                matched by patch; a patch at another slot only across a
                near-tie within 1e-6); the regions embedded by the serve
                config's model and scored at 64 x 64 by combined_sims (the
                f32 forward, launch counts reset just before and read just
                after); frames/s and the sims time;
 14. timing   — each kernel and its plain version on the main paths' own
                inputs, beside the card's bound for the same work (f32 mode:
                3 TF32 passes at the TF32 peak, the f32 FFMA bound printed
                beside it) and beside its previous design's time: the
                serving forward, the training kernels at f = 1 (the bf16
                forward beside its FFMA design's time, with its split S and
                the profiler required to see xattn_sim_fwd_bf16_kernel) and
                the forward and backward kernels at f = 8 (the fine-tune's first
                batch; each backward beside its one-block-an-item time, with
                the split S it chose and the kernels the profiler saw),
                the f32 forward on the 64-query call's inputs, the bf16
                forward and the backward pair on a -fast step at its most
                frequent bucket, grouped attention at the region tower's
                f = 8 shapes (both of its kernels) beside torch's
                scaled_dot_product_attention; the profiler's names of the
                kernels that ran; and one step each of the train and
                fine-tune runs split into towers, loss, backward and
                optimizer, and by kernel with the profiler;
 15. mfu      — the model FLOPs of a step (utils/flops.py's analytic model at
                each run's shapes and widths) and the MFU of the fenced
                medians of train, pretrain-fast (a bucket at a time) and the
                f = 8 fine-tune against the card's dense bf16 peak; beside
                them FlopCounterMode's count of one pre-training step (aten
                ops only) against the model's towers and global sims;
 15b. resume — configs/bench/ab_local_bf16.json at full width with
                precision.norm "bfloat16" and loss.args.local_block_segment
                32: the bf16 forward and both backward kernels at 32 x 128 and
                128 x 32 against their plain versions (reruns bit-identical,
                a block's sims equal to the whole call's); one step blocked
                and one unblocked from the same weights, batch and dropout
                key (the loss bit for bit, the gradients within
                RESUME_BLOCK_GRAD_TOL), and one with f32 norms (losses,
                fenced step ms, kernel launches a step from torch.profiler);
                the train CLI in process for 2 epochs of 4 steps with the
                asynchronous save (launch counts reset just before and read
                just after; its block-shape kernel times; each save's stall
                on the training thread, its write's time, each epoch's wall
                time); then the train CLI in a subprocess killed with
                SIGKILL once epoch 1's .pth is committed, and the same
                command again with trainer.resume "auto" and the blocking
                save (trainer.async_checkpoint false; its save's stall and
                epoch wall read from its log): its epoch-2 weights and AdamW
                moments must equal the uninterrupted run's, which checks the
                resume and the two save modes' files at once (the largest
                difference printed);
 16. dist     — the parallel layer (parallel/mesh.py, parallel/tp.py), last,
                so every phase before it runs as it did before the layer: (a)
                NCCL at world size 1: the train CLI on the smoke config under
                torchrun's environment (setup_distributed joins no group, so
                it is the one-process path), then a world-1 NCCL group, the
                (1, 1) mesh, the row gather and the gradient sum through it;
                (b) two gloo ranks sharing the card (NCCL refuses two ranks on
                one device), each killed after DIST_TIMEOUT s: 2 data-parallel
                train steps of configs/bench/ab_local_bf16.json at 64 rows a
                rank (global 128) held to the one-process 128-row steps on the
                concatenated batches (losses, step-1 gradients, parameters,
                the ranks' weights identical; the rank's gradient before the
                sum, a planted fault, must fail the gradient limit), the bf16
                forward and both backward kernels launched on every rank and
                in the one-process run; the 1000-video gallery of the serve
                config embedded from two loader shards and scored in two
                blocks of gallery rows, held to [serve]'s embeddings and to
                one-process scoring of the same embeddings (top-10
                identical); one f32 tensor-parallel step at mesh (1, 2) of
                ab_local_bf16.json's widths at depth 2 on 128 rows (the f32
                kernels at phase 3's 128 x 128 shapes) against the one-rank
                step. Times are of two processes sharing one card and claim
                nothing about speed.
With --torchrun, under torchrun on N cards (N even, one process a card,
NCCL), only (b)'s checks run, each rank on its own card: data parallel at
128 / N rows a rank, data and tensor parallel at mesh (N / 2, 2), the
gallery over N ranks; then the host gathers' cost beside a busy card
(through their gloo group and, as a comparison, through NCCL on the card)
and one epoch of configs/bench/ab_local_bf16_fast.json at 128 / N rows a
rank (its text buckets agreed across the ranks each step).
Phase 3 also holds the backward kernels at the f = 8 shapes (32 x 32 items,
(Ls, Lq) = (240, 99) and (99, 240)), and at 40 x 37 items where the partner
loop is split raggedly over S blocks an item (resident and workspace
layouts, both modes), the bf16 forward at ragged shapes and partner
splits (BF16_FWD_RAGGED), and the grouped-attention kernels at the
region tower's f = 8 shapes and at a shape on each side of their dispatch
against their plain versions, and an attention-op phase drives
`grouped_attention_fused` (forward and backward) at those shapes, its launch
counts reset just before and read just after.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
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
FAST_CFG = ROOT / "configs" / "bench" / "ab_local_bf16_fast.json"
# the -fast path's text buckets (trainer.text_buckets of
# configs/pt/o2t-cl-local-select-loss-cc-fast.json and FAST_CFG)
FAST_BUCKETS = (32, 48, 64)
# the bucket each of FAST_CFG's 16 epoch-1 batches lands in, worked out on
# the CPU (the loader's length-grouped batch indices and the tokenizer,
# no card); the [pretrain-fast] phase also works it out again on the host
FAST_EPOCH1_LENGTHS = [32] * 9 + [64] + [32] * 6
# [query]: free-text queries beside the gallery's own first captions
QUERY_FREE_TEXT = ["a man plays ball with a dog in the park", "red car on the street",
                   "a child is walking near the water and a large tree",
                   "music video shows a group of people"]
QUERY_SLICE = 100  # gallery videos in the card vs CPU comparison
# [query], card vs CPU on the same slice, each side embedding the queries
# with its own bf16 text tower: the text embeddings differ by bf16 round-off
# (TOL_BF16_CARD of their largest entry, [bf16]), and the sims (global
# cosine in [-1, 1] plus local cosine means in [-2, 2]) by a few times that
TOL_QUERY_CARD = 3 * 0.03
# the region tower's grouped attention at f = 8, k = 30, batch 32, 12 heads,
# hd = 64, as (groups, query rows, keys): space (a frame's regions and the
# CLS key), time (a region over the frames and the CLS key), the CLS row over
# everything, and full attention
ATTN_SHAPES = {"space": (3072, 30, 31), "time": (11520, 8, 9), "cls": (384, 1, 241),
               "full": (384, 241, 241)}
# one group shape on each side of the attention kernels' dispatch in bf16
# (ops/attention_kernel.kernel_path: the head width): hd = 48 takes the
# FFMA kernel, hd = 128 the mma kernel
ATTN_DISPATCH_SIDES = {"full hd=48": ((64, 241, 241), 48), "full hd=128": ((64, 241, 241), 128)}
# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores, dense TF32 and bf16 on the tensor cores, and device-memory
# bandwidth. An f32-mode kernel's operation bound is 3 TF32 passes (the
# 3xTF32 products that hold f32 accuracy) at the TF32 peak; the f32 FFMA
# figure is printed beside it
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
TF32_PASSES = 3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# this kernel's times in the previous design (FFMA products), read on an
# H100 80GB HBM3 at 700 W with this script: printed beside the new ones
# (the bf16 forward's: one pre-training step's two launches at f = 1)
PREV_MS = {"xattn_sim_fwd serve": 2777.7, "grouped_attention full": 2.099,
           "grouped_attention four shapes": 2.441, "xattn_sim_fwd_bf16 train": 11.535}
# the bf16 forward at ragged shapes, (Bc, Bq, Ls, Lq, D): Lq past a 16-row
# tile, Ls past 8, 16 and 32 columns and past the 256 softmax columns a warp
# keeps in registers, D not a multiple of 16 or 8; 40 x 37 items split the
# 40 partners of a held item raggedly over S blocks
BF16_FWD_RAGGED = [(6, 5, 13, 40, 20), (6, 5, 13, 40, 36), (6, 5, 300, 40, 256),
                   (40, 37, 30, 99, 256), (37, 40, 99, 30, 256)]
# the backward kernels' times a step before their partner loop was split
# over blocks (one block an item), read the same way: printed beside the
# new ones, keyed by the timing tag and kernel name
PREV_BWD_MS = {("train", "xattn_sim_bwd_dq"): 40.897, ("train", "xattn_sim_bwd_dc"): 42.672,
               ("finetune f=8", "xattn_sim_bwd_dq"): 44.847,
               ("finetune f=8", "xattn_sim_bwd_dc"): 56.957}
# a backward case whose split is ragged: 40 contexts x 37 queries (items
# below the card's slots, so each item's partners are split over S blocks,
# and 37 is no multiple of d_context's S), at the f = 1 pre-training and
# the f = 8 fine-tune lengths (resident and workspace layouts)
SPLIT_CASES = {"resident": (40, 37, 30, 99), "workspace": (40, 37, 240, 99)}
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
# f32 is summation order only, but for the backward's leaky-ReLU kink
# (KINK_A0 below). Under focal 'equal' a near-tie flip moves
# one position's weight, and in bf16 mode a last-digit difference before
# an operand's rounding moves that operand by one bf16 ulp (2^-8); each
# moves a few entries by much more than the rest, so those are held at a
# looser limit for the largest error with the share beyond the tight one
# kept small. Read on an H100 80GB HBM3 (700 W limit), training shapes at
# f = 1: f32 2.7e-6 at most (forward and backward), bf16 forward 5.8e-5
# (1.5e-4 at the ragged shapes) and bf16 backward 1.6e-3, no flip beyond
# these in either focal type; at f = 8 (32 x 32 items): f32 2.4e-6 at most,
# bf16 forward 3.0e-5, bf16 backward 3.7e-3 with at most 4.8e-5 of the
# entries beyond 2e-3.
TOL_TRAIN = {"f32": 1e-5, "bf16": 2e-3}
TOL_TRAIN_FLIP = 2e-2
MAX_TRAIN_FLIP_SHARE = 1e-2
# the backward's other flip, in every mode and focal type: the leaky-ReLU's
# slope jumps from 1 to 0.1 at a0 = qn . cn = 0, so where a pair's a0 lies
# within rounding of 0 two summation orders can take different slopes and
# move that pair's context row s and query row l (one element of da0) by
# up to 0.9 |da1|. Two f32 orders of a 256-term dot product of unit
# vectors differ by about 1e-7 here; KINK_A0 is ten times that. In f32
# 'prob' (no other flip allowance) a backward entry may exceed TOL_TRAIN
# only in a row with such a pair, and only by 0.9 |da1| summed over the
# row's such pairs, through the row's l2norm backward (kink_bounds, in
# float64). Seen at the text-bucket shapes:
# context item 5 row 5 against query item 3 row 16 of the seeded
# 128 x 128 inputs at Lq = 63, a0 = -7.8e-9 in float64, d_context 9.1e-5
# and d_query 2.8e-4 of the largest entry in those two rows, where a
# float64 evaluation agreed with the plain version
KINK_A0 = 1e-6
# remat against no remat, one bf16 step on the card: the region tower's
# gradients, max |diff| / max |g| a tensor. The recompute runs the same
# kernels on the same values, so they should agree bit for bit; the limit
# is the bf16 kernels' (TOL_TRAIN), room for a reordered sum, far below
# what a wrong recompute (a stale mask, other dropout draws) moves
REMAT_GRAD_RTOL = TOL_TRAIN["bf16"]
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
# the real-data phase: configs/ft/msvd_o2t-select.json over the first rows
# of the committed MSVD split files (real ids and captions) and a region
# tree written from a seed in the bottom-up-attention layout: 8-12 frames a
# video (f = 8 sampling finds distinct frames), 10-36 regions a frame (top-30
# selection pads some), one file in eight np.savez_compressed
MSVD_CFG = ROOT / "configs" / "ft" / "msvd_o2t-select.json"
RD_ROWS = {"MSVD_train.tsv": 512, "MSVD_test.tsv": 256}
RD_FRAMES = (8, 12)
RD_REGIONS = (10, 36)
RD_SEED = 8
RD_LOADER_BATCHES = 16
# [record]: the run record's steps, and the runs with and without the writer
RECORD_STEPS = 16
# [profile]: unfenced steps of the pre-training trainer inside the trace,
# and the host spans its loop opens around each step's pieces
PROFILE_STEPS = 6
PROFILE_SPANS = ("data", "prepare", "to_device", "step", "consume")
# the device's own events in the trace (kernels, copies, fills)
TRACE_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# [extractor]: PatchRegionExtractor at its default widths (384 x 6 layers x
# 6 heads, patch 16) on seeded 224 x 224 frames, f and k from the serve
# config; 64 videos in batches of 16. Card vs CPU on one batch in f32 with
# the same weights: `object` within 1e-4 of its largest |entry| (f32
# products in another order through 6 blocks; no TF32, device.py), `conf`
# within 1e-8 (softmax masses near 1/196, whose f32 spacing is 4.7e-10;
# read: 1.4e-9 at most on an H100). At random init the saliency is
# near-uniform: a frame's 196 confidences span about 2% of 1/196, so
# neighbours in the sorted order lie about 5e-7 apart, and the two
# devices' f32 differences swap a few of them (read: 6 of 3840 slots,
# across gaps of 9.3e-10 at most). So regions are matched by patch: each
# patch both devices selected within the object tolerance, and each patch
# selected at another slot or on one side only a near-tie, its confidences
# within EX_TOL_CONF of the other side's at that slot (or of its last kept
# one), in at most EX_MAX_SWAP_SHARE of the slots. An order off by one
# slot crosses a neighbour gap of about 5e-7 and fails.
EX_VIDEOS = 64
EX_BATCH = 16
EX_SEED = 10
EX_TOL_OBJECT = 1e-4
EX_TOL_CONF = 1e-8
EX_MAX_SWAP_SHARE = 5e-3
# [dist]: two gloo ranks share the one card (NCCL refuses two ranks on one
# device). Each spawned rank is killed after DIST_TIMEOUT s.
DIST_TIMEOUT = 600
DIST_ROWS = 64  # rows a rank in the data-parallel train steps (global 128)
DIST_STEPS = 2
# data parallel at full width against the one-process 128-row steps, bf16
# towers and local loss: the ranks run their towers on 64 rows, so bf16
# products may round differently (TOL_TRAIN's bf16 limit for the loss).
# The step-1 gradients, summed over the ranks, lie within DIST_GRAD_TOL of
# the one-process gradients, tensor by tensor in 2-norm (|diff| / |value|).
# The towers run in bf16 on other row counts, and the difference grows
# through the backward: on an H100 80GB HBM3 at 700 W the object tower's
# first weight, under 12 blocks, read 2.35e-2 (1.6e-2 its position embed
# and CLS token), the text tower less. The faults the check is for read
# 0.5 (a mean taken for the sum) and 1.22 (the sum skipped: the rank's
# gradient before the sum, which the check reads as a planted fault and
# which must lie beyond the limit, or the check sees nothing). The limit
# sits 4x above the first and 5x below the second. Left out: the
# attention key biases, whose exact gradient is zero (_exact_zero_grad).
# Adam normalises the gradient, so a scale fault in the sum moves neither
# the loss nor the parameters: only the gradients show it. An Adam update
# is close to lr * sign(g), so where a gradient is within rounding of zero
# an element may move the other way in the two runs; the mean |change|
# over the model must stay within DIST_PARAM_MEAN * lr (read 0.0174 lr)
DIST_GRAD_TOL = 0.1
DIST_LOSS_RTOL = TOL_TRAIN["bf16"]
DIST_PARAM_MEAN = 0.05
# tensor parallelism: one f32 step of ab_local_bf16.json's widths at depth
# DIST_TP_DEPTH in each tower, mesh (1, 2), DIST_TP_ROWS rows (so the f32
# kernels run at phase 3's 128 x 128 training shapes), against the one-rank
# step: f32 summation order only (TRAIN_REF_LOSS_RTOL, TRAIN_REF_PARAM; a
# parameter at most 2 * ADAM_STEP_MAX * lr from the one-rank step, as
# opposite Adam moves can be: no update of the first steps exceeds 1.0014
# lr at betas 0.9 / 0.999)
ADAM_STEP_MAX = 1.01
DIST_TP_DEPTH = 2
DIST_TP_ROWS = 2 * DIST_ROWS
# --torchrun: the card kept busy while a host gather is timed (about 0.1 s
# at the H100's 1.98 GHz boost clock)
SPIN_CYCLES = 200_000_000


# [resume]: configs/bench/ab_local_bf16.json at full width with
# precision.norm "bfloat16" and loss.args.local_block_segment RESUME_SEGMENT,
# 2 epochs of 4 steps of 128 (num_samples and max_samples_per_epoch
# RESUME_SAMPLES; validation over RESUME_SAMPLES val rows after each
# epoch), monitor "min val_loss_0" so that model_best.pth is copied when
# validation improves. Each train CLI subprocess is killed after
# RESUME_TIMEOUT s.
RESUME_SEGMENT = 32
RESUME_SAMPLES = 512
RESUME_TIMEOUT = 420
# blocked against unblocked, one bf16 step from the same weights, batch and
# dropout key: the loss bit for bit (every sim is computed pair by pair).
# The gradients tensor by tensor in 2-norm (|diff| / |value|): each block's
# share of a caption's gradient leaves its direction rounded to bf16 and
# the shares are summed after, and the backward kernels split a 32-item
# call's partner loops by another S, so a gradient moves by bf16 rounding
# (2^-8 relative a share), carried through the towers' backward: read
# 8.9e-3 at most (a LayerNorm bias) in a CPU rehearsal at the smoke
# config's widths with the bf16 local loss. A block left out or counted
# twice moves a tensor's gradient by O(1).
RESUME_BLOCK_GRAD_TOL = 5e-2
# a block's backward against the whole call's with the cotangent zero
# outside the block: the same pairs' shares, summed over S partials of
# another split (f32 order only). Read on an H100 80GB HBM3 (700 W):
# d_query 0.0, d_context 2.2e-7 of the largest entry at 32 x 128
BLOCK_BWD_ORDER = TOL_TRAIN["f32"]
# the flip allowance where a backward entry sums over a block's partners
# (i2t d_query, t2i d_context): a focal near-tie flip moves one pair's
# share, while the largest entry sums `segment` random-signed shares in
# place of n, so against it a flip is sqrt(n / segment) times as large as
# at n x n (2 at 32 of 128). Read on an H100 80GB HBM3 (700 W), focal
# "equal", i2t d_query: 2.654e-2 of the largest |plain| at 32 x 128 over
# 6.6e-5 of the entries, and bit for bit the same numbers from the 128 x
# 128 call with the cotangent zero outside the block (no flip beyond 2e-3
# in the prob cases)


def block_flip_scale(n: int, segment: int) -> float:
    return (n / segment) ** 0.5


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


def kink_bounds(ctx: torch.Tensor, qry: torch.Tensor, cmask: torch.Tensor, g: torch.Tensor,
                lam: float, focal_equal: bool):
    """(context (Bc, Ls), query (Bq, Lq)) float64: the most the leaky-ReLU's
    slope flips can move one gradient entry of each row. A pair with
    |a0| = |qn . cn| < KINK_A0 (float64) may take the other slope in
    another summation order. That moves its da0 by 0.9 |da1| (da1 from the
    plain backward in float64), its qn and cn rows by at most that (unit
    vectors), and every entry of the row through the l2norm backward by at
    most that over |x| + eps. Zero in a row with no such pair."""
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    c, q, m, gg = (t.double() for t in (ctx, qry, cmask, g))
    cb = torch.zeros(ctx.shape[:2], dtype=torch.float64, device=ctx.device)
    qb = torch.zeros(qry.shape[:2], dtype=torch.float64, device=qry.device)
    blk = xk._BLOCK
    for c0 in range(0, ctx.shape[0], blk):
        cs = slice(c0, c0 + blk)
        for q0 in range(0, qry.shape[0], blk):
            qs = slice(q0, q0 + blk)
            da1, f, _, _ = xk.backward_da1(c[cs], q[qs], m[cs], gg[cs, qs], lam,
                                           focal_equal, False)
            move = torch.where(f["a0"].abs() < KINK_A0, 0.9 * da1.abs(), 0.0)
            cb[cs] += move.sum(dim=(1, 2))
            qb[qs] += move.sum(dim=(0, 3))
            del da1, f, move
    return cb / (c.norm(dim=-1) + 1e-8), qb / (q.norm(dim=-1) + 1e-8)


def check_backward(name: str, got: torch.Tensor, want: torch.Tensor, tol: float, flip,
                   bound: torch.Tensor | None) -> float:
    """A backward result against its plain version. With a flip allowance
    (`flip`: focal 'equal', bf16 mode) as check_rel holds it. Without one
    (f32 'prob') every entry within tol of the largest |plain| entry, and in
    a row with a leaky-ReLU kink pair within that plus what the pair's
    slope flip can move there (`bound`, kink_bounds)."""
    if flip[0]:
        return check_rel(name, got, want, tol, *flip)
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite kernel output")
    scale = float(want.abs().max()) or 1.0
    err = (got.double() - want.double()).abs()
    beyond = err > tol * scale
    over = err > tol * scale + bound[..., None]
    kink = bound > 0
    log(f"[kernels] {name}: max |err| / max |plain| {float(err.max()) / scale:.3e} (max "
        f"|plain| {scale:.3e}); {int(kink.sum())} of {kink.numel()} rows hold a leaky-ReLU "
        f"kink pair (largest row bound {float(bound.max()) / scale:.3e} of max |plain|); "
        f"{int(beyond.sum())} entries beyond {tol:g}, in {int(beyond.any(-1).sum())} rows")
    if bool(over.any()):
        fail(f"{name}: {int(over.sum())} entries beyond {tol:g} of max |plain| plus their "
             f"row's leaky-ReLU flip bound ({int((over.any(-1) & ~kink).sum())} of those "
             "rows hold no kink pair)")
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
    return name, card


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


def phase_kernels_train(device, n: int = 128, regions: int = 30, seed: int = 2,
                        words: int = 99, buckets: bool = False) -> dict:
    """The training shapes: n x n items, D = 256, regions (Ls = `regions`:
    30 at f = 1, 240 at f = 8) and words (99; a text bucket's b - 1) in
    both directions; both modes, both focal types. With `buckets` the f32
    forward is also run twice and held bit-identical, and each direction
    prints the S its launchers chose. The worst max abs error of each
    kernel is returned."""
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    reg, rmask = _train_inputs(seed, n, regions, 256, device)
    wrd, wmask = _train_inputs(seed + 1, n, words, 256, device)
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
                if (bf16 or buckets) and not torch.equal(got, xk.direction_sim(*args)):
                    fail(f"{tag}: two {mode} forward runs differ (must be bit-identical)")
                if buckets and focal == "equal":
                    bc, ls, d = ctx.shape
                    bq, lq, _ = qry.shape
                    fwd_s = xk.bf16_forward_splits(bc, bq, ls, lq, d) if bf16 else 1
                    log(f"[kernels] {tag}: S chosen: forward {fwd_s}"
                        + ("" if bf16 else " (f32: a block a pair)") + ", (S, slots) d_query "
                        f"{xk.backward_plan(xk.KERNEL_DQ, ctx, qry, bf16)}, d_context "
                        f"{xk.backward_plan(xk.KERNEL_DC, ctx, qry, bf16)}")
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
                cb, qb = (None, None) if flip[0] else kink_bounds(ctx, qry, cm, g, 20.0, eq)
                worst[xk.KERNEL_DC] = max(worst[xk.KERNEL_DC], check_backward(
                    f"{tag} d_context", dc, pdc, tol, flip, cb))
                worst[xk.KERNEL_DQ] = max(worst[xk.KERNEL_DQ], check_backward(
                    f"{tag} d_query", dq, pdq, tol, flip, qb))
                if float(dc[1].abs().max()) != 0.0:
                    fail(f"{tag}: a fully masked context item must get a zero gradient")
    log(f"[kernels] training shapes {n}x{n}, {regions} regions, {words} words: backward "
        "kernels" + (" and both forwards" if buckets else "") + " bit-identical on rerun in "
        "every case")
    return worst


def phase_kernels_buckets(device) -> dict:
    """The -fast pre-training's bucket shapes: 128 x 128 items, D = 256,
    (Ls, Lq) = (30, b - 1) and (b - 1, 30) for each text bucket b, every
    kernel in both modes against its plain version, each run twice and held
    bit-identical (FAST_BUCKETS). The worst max abs error of each kernel."""
    worst = {}
    for b in FAST_BUCKETS:
        for k, v in phase_kernels_train(device, seed=60 + b, words=b - 1, buckets=True).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def phase_kernels_splits(device) -> dict:
    """The backward kernels where each item's partners are split raggedly
    over S blocks (SPLIT_CASES), both modes, focal 'equal', against the
    plain backward at TOL_TRAIN; bit-identical reruns, a fully masked item's
    zero gradient. The worst max abs error of each kernel is returned."""
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    worst = {xk.KERNEL_DQ: 0.0, xk.KERNEL_DC: 0.0}
    for layout, (bc, bq, ls, lq) in SPLIT_CASES.items():
        ctx, cmask = _train_inputs(40, bc, ls, 256, device)
        qry, _ = _train_inputs(41, bq, lq, 256, device)
        g = torch.randn(bc, bq, generator=torch.Generator().manual_seed(42)).to(device)
        for mode in ("f32", "bf16"):
            bf16 = mode == "bf16"
            c, q = (xk.round_bf16(ctx), xk.round_bf16(qry)) if bf16 else (ctx, qry)
            plan = {k: xk.backward_plan(k, c, q, bf16) for k in (xk.KERNEL_DQ, xk.KERNEL_DC)}
            s_dc = plan[xk.KERNEL_DC][0]
            if s_dc < 2 or bq % s_dc == 0:
                fail(f"split case {layout}: d_context's S = {s_dc} does not split {bq} "
                     "partners raggedly")
            tag = (f"split {bc}x{bq} Ls={ls} Lq={lq} {layout} {mode} (S, slots: d_query "
                   f"{plan[xk.KERNEL_DQ]}, d_context {plan[xk.KERNEL_DC]})")
            bargs = (c, q, cmask, g, 20.0, True, bf16)
            dc, dq = xk.direction_sim_bwd(*bargs)
            dc2, dq2 = xk.direction_sim_bwd(*bargs)
            pdc, pdq = xk.direction_sim_bwd_plain(*bargs)
            torch.cuda.synchronize()
            if not (torch.equal(dc, dc2) and torch.equal(dq, dq2)):
                fail(f"{tag}: two backward runs differ (no atomics: must be bit-identical)")
            flip = (TOL_TRAIN_FLIP, MAX_TRAIN_FLIP_SHARE)
            worst[xk.KERNEL_DC] = max(worst[xk.KERNEL_DC], check_rel(
                f"{tag} d_context", dc, pdc, TOL_TRAIN[mode], *flip))
            worst[xk.KERNEL_DQ] = max(worst[xk.KERNEL_DQ], check_rel(
                f"{tag} d_query", dq, pdq, TOL_TRAIN[mode], *flip))
            if float(dc[1].abs().max()) != 0.0:
                fail(f"{tag}: a fully masked context item must get a zero gradient")
    log("[kernels] ragged splits: backward kernels bit-identical on rerun in every case")
    return worst


def phase_kernels_bf16_forward(device) -> float:
    """The bf16 forward (xattn_sim_fwd_bf16_kernel) at BF16_FWD_RAGGED, both
    focal types, against its plain version at TOL_TRAIN["bf16"] with its
    flip allowance; two runs bit-identical, a fully masked item scoring 0.
    Returns the worst max abs error."""
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    worst = 0.0
    for bc, bq, ls, lq, d in BF16_FWD_RAGGED:
        ctx, cmask = _train_inputs(50, bc, ls, d, device)
        qry, _ = _train_inputs(51, bq, lq, d, device)
        ctx, qry = xk.round_bf16(ctx), xk.round_bf16(qry)
        splits = xk.bf16_forward_splits(bc, bq, ls, lq, d)
        for focal in ("prob", "equal"):
            args = (ctx, qry, cmask, 20.0, focal == "equal", True)
            got, again = xk.direction_sim(*args), xk.direction_sim(*args)
            want = xk.direction_sim_plain(*args)
            torch.cuda.synchronize()
            tag = f"bf16 forward {bc}x{bq} Ls={ls} Lq={lq} D={d} {focal} (S = {splits})"
            if not torch.equal(got, again):
                fail(f"{tag}: two runs differ (one writer an output: must be bit-identical)")
            worst = max(worst, check_rel(tag, got, want, TOL_TRAIN["bf16"], TOL_TRAIN_FLIP,
                                         MAX_TRAIN_FLIP_SHARE))
            if float(got[1].abs().max()) != 0.0:
                fail(f"{tag}: fully masked context item must score 0")
    log("[kernels] bf16 forward at ragged shapes: bit-identical on rerun in every case")
    return worst


def _attn_inputs(shape, dtype, device, seed: int, hd: int = 64):
    """q (scaled by hd^-0.5), k, v in `dtype` and an f32 bias of 0 / -100
    for one grouped-attention shape; the first key of every group (the CLS
    key) visible, and group 1 masked throughout."""
    g, lq, lk = shape
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(g, lq, hd, generator=gen) * hd ** -0.5
    k = torch.randn(g, lk, hd, generator=gen)
    v = torch.randn(g, lk, hd, generator=gen)
    bias = ((torch.rand(g, lk, generator=gen) > 0.2).float() - 1.0) * 100.0
    bias[:, 0] = 0.0
    bias[1] = -100.0
    return [t.to(dtype).to(device) for t in (q, k, v)] + [bias.to(device)]


def phase_kernels_attention(device) -> float:
    """grouped_attention against grouped_attention_plain at the region
    tower's f = 8 shapes, f32 and bf16, and at a bf16 shape on each side of
    the dispatch; each case names the kernel it ran. Returns the worst max
    abs error."""
    from demovlp_tpu_torch.ops import attention_kernel as ak

    cases = [(f"{name} {mode}", shape, 64, dtype)
             for mode, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))
             for name, shape in ATTN_SHAPES.items()]
    cases += [(f"{name} bf16", shape, hd, torch.bfloat16)
              for name, (shape, hd) in ATTN_DISPATCH_SIDES.items()]
    worst = 0.0
    for name, shape, hd, dtype in cases:
        mode = "bf16" if dtype == torch.bfloat16 else "f32"
        args = _attn_inputs(shape, dtype, device, seed=10, hd=hd)
        path = ak.kernel_path(dtype, hd)
        before = ak.LAUNCHES[path]
        got = ak.grouped_attention(*args)
        want = ak.grouped_attention_plain(*args)
        if got.dtype != dtype or ak.LAUNCHES[path] != before + 1:
            fail(f"grouped_attention {name}: result dtype {got.dtype}, or the {path} kernel "
                 "did not run")
        worst = max(worst, check_rel(f"grouped_attention {name} G,Lq,Lk={shape} hd={hd} "
                                     f"({path} kernel)", got, want, TOL_ATTN[mode]))
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
        f"kernel launches {launches} (grouped_attention_mma_kernel {ak.LAUNCHES[ak.MMA]}, "
        f"grouped_attention_kernel {ak.LAUNCHES[ak.FFMA]})")
    if launches != len(ATTN_SHAPES) or ak.LAUNCHES[ak.MMA] != launches or not grads_ok:
        fail(f"the op path launched the kernels {dict(ak.LAUNCHES)} times (expected "
             f"{len(ATTN_SHAPES)} of the mma kernel in bf16) or gave non-finite gradients")
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
    if launches[xk.KERNEL] != 2:
        fail(f"the serving path launched the f32 forward {launches[xk.KERNEL]} times "
             "(expected 2: one a direction)")
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
    config) from the seeded init, its text buckets and MLM objective
    included (masks drawn as the trainer draws them, from default_rng(1)):
    (losses, step-1 gradients, parameters after step 2), on the host."""
    from demovlp_tpu_torch.cli import common
    from demovlp_tpu_torch.data.mlm import mask_batch_text_tokens
    from demovlp_tpu_torch.train.steps import (batch_to_device, make_retrieval_train_step,
                                               parse_text_buckets, prepare_batch)

    cfg = cfg or json.loads(SMOKE_CFG.read_text())
    model = common.build_train_model(cfg, device, seed=0)
    opt = common.build_optimizer(cfg, model.parameters())
    mlm = cfg.get("mlm", {}) or {}
    weight = float(mlm.get("weight", 0.0))
    step = make_retrieval_train_step(model, common.build_loss(cfg), opt, deterministic=True,
                                     mlm_weight=weight)
    dl = common.init_dataloaders(cfg)[0][0]
    dl.set_epoch(1)
    tok = common.build_tokenizer_from_config(cfg)
    buckets = parse_text_buckets(cfg["trainer"])
    mask_rng = np.random.default_rng(1)
    lr = float(cfg["optimizer"]["args"]["lr"])
    losses, grads = [], None
    for _, data in zip(range(2), dl):
        arrays = prepare_batch(data, tok, text_buckets=buckets)
        if weight:
            arrays["input_ids"], arrays["mlm_labels"] = mask_batch_text_tokens(
                arrays["input_ids"], arrays["attention_mask"], int(mlm.get("mask_token_id", 103)),
                model.text_model.config.vocab_size, mask_rng, float(mlm.get("mask_prob", 0.15)))
        m = step(batch_to_device(arrays, device), lr)
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
        for k in ("loss", "global_loss", "local_loss", "mlm_loss"):
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


def _first_batch_local(trainer, length: int | None = None):
    """The local embeddings and masks of a train run's first batch (f32),
    its text trimmed to the run's buckets; with `length`, of the first
    batch whose text is that long."""
    from demovlp_tpu_torch.ops.masking import additive_mask
    from demovlp_tpu_torch.train.steps import batch_to_device, prepare_batch

    dl = trainer.data_loader[0]
    dl.set_epoch(1)
    for data in dl:
        arrays = prepare_batch(data, trainer.tokenizer, text_buckets=trainer.text_buckets)
        if length is None or arrays["input_ids"].shape[1] == length:
            break
    else:
        fail(f"no batch of {length} tokens in the run's first epoch")
    batch = batch_to_device(arrays, trainer.device, trainer.transfer_dtype)
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


def phase_qa(tmp: Path, device):
    """train_qa at full width on configs/bench/qa_synthetic_f8.json, then
    card vs CPU on the smoke config. Returns the full-width trainer."""
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
    card, cpu = _two_qa_steps(device), _two_qa_steps(torch.device("cpu"))
    err = float((card[1] - cpu[1]).abs().max())
    log(f"[qa] smoke config, two f32 steps: losses card {card[0]} cpu {cpu[0]}; logits after "
        f"them max abs err {err:.3e}")
    for a, b in zip(card[0], cpu[0]):
        if not np.isfinite(a) or abs(a - b) > TRAIN_REF_LOSS_RTOL * abs(b) + 1e-6:
            fail(f"QA loss card {a} vs cpu {b}")
    if not torch.allclose(card[1], cpu[1], **QA_LOGITS_TOL):
        fail(f"QA logits after two steps: card vs cpu max abs err {err}")
    return trainer


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


def _fast_lengths_on_host(cfg, epoch: int = 1) -> list:
    """The text length of each train batch of `epoch` for a bucketed,
    length-grouped config, worked out on the host: the loader's batch
    indices, each sample's caption and the tokenizer; no card."""
    from demovlp_tpu_torch.cli import common
    from demovlp_tpu_torch.train.steps import parse_text_buckets, prepare_batch

    dl = common.init_dataloaders(cfg, train=True)[0][0]
    dl.set_epoch(epoch)
    tok, ds = common.build_tokenizer_from_config(cfg), dl.dataset
    buckets = parse_text_buckets(cfg["trainer"])
    lengths = []
    for idx in dl.batch_indices():
        batch = {"text": [ds._text(int(i), None) for i in idx],
                 "object": np.zeros((len(idx), 1, 1, 2054), np.float32),
                 "object_mask": np.ones((len(idx), 1, 1), np.float32)}
        lengths.append(int(prepare_batch(batch, tok, text_buckets=buckets)["input_ids"].shape[1]))
    return lengths


def phase_pretrain_fast(tmp: Path, device, pretrain):
    """The train CLI at full width on configs/bench/ab_local_bf16_fast.json
    (the -fast path: length-grouped batches, text trimmed to 32 / 48 / 64):
    16 steps, then validation; launch counts reset just before and read
    just after, by kernel and by (Ls, Lq)."""
    from demovlp_tpu_torch.cli.train import run
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    cfg = json.loads(FAST_CFG.read_text())
    cfg["trainer"].update(epochs=1, save_dir=str(tmp / "fast"))
    path = tmp / "fast.json"
    path.write_text(json.dumps(cfg))
    predicted = _fast_lengths_on_host(cfg)
    log(f"[pretrain-fast] host prediction of the 16 batches' text lengths: {predicted} "
        f"(worked out on the CPU before any chip call: {FAST_EPOCH1_LENGTHS})")
    if predicted != FAST_EPOCH1_LENGTHS:
        fail("the host's bucket prediction differs from the CPU's")
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    xk.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = run(["-c", str(path)], fence_steps=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, shapes = dict(xk.LAUNCHES), dict(xk.SHAPE_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    steps, losses, lens = trainer.step_times, trainer.step_losses, trainer.step_text_lens
    log(f"[pretrain-fast] {len(steps)} steps of {trainer.data_loader[0].batch_size} (f=1, k=30, "
        f"bf16 towers and local loss, full width, long-tail captions, length-grouped, "
        f"buckets {list(FAST_BUCKETS)}); wall with validation and checkpoint {wall:.1f}s; "
        f"peak device memory {peak / 2**30:.3f} GiB ({(peak - held) / 2**30:.3f} GiB beyond "
        f"the {held / 2**30:.3f} GiB held before the run)")
    for i, (n, t, loss) in enumerate(zip(lens, steps, losses)):
        log(f"[pretrain-fast] step {i + 1}: text length {n} (Lq = {n - 1}), fenced step "
            f"{1e3 * t:.3f} ms, loss {loss:.6f}")
    for n in sorted(set(lens)):
        # step 1 carries first-use costs: left out where its bucket has others
        ts = [t for i, (m, t) in enumerate(zip(lens, steps)) if m == n and i > 0] or [steps[0]]
        log(f"[pretrain-fast] bucket {n}: {lens.count(n)} steps, median fenced step "
            f"{1e3 * float(np.median(ts)):.3f} ms over {len(ts)} of them")
    train_ms = 1e3 * float(np.median(pretrain.step_times[1:]))
    log(f"[pretrain-fast] beside it, this call's [train] median step at Lq = 99 (fixed length "
        f"100, short captions): {train_ms:.3f} ms (no claim: other captions, other batches)")
    log(f"[pretrain-fast] kernel launches in this run: {launches}")
    for (name, ls, lq), count in sorted(shapes.items()):
        log(f"[pretrain-fast]   {name} (Ls, Lq) = ({ls}, {lq}): {count}")
    log(f"[pretrain-fast] val R@1 {trainer.final_log['val_0_t2v_metrics_R1']} (t2v), "
        f"v2t R@1 {trainer.final_log['val_0_v2t_metrics_R1']}")
    if len(steps) != 16 or not all(np.isfinite(losses)):
        fail(f"expected 16 finite -fast steps, got {losses}")
    if lens != predicted:
        fail(f"the steps' text lengths {lens} differ from the prediction {predicted}")
    if len(set(lens)) < 2:
        fail(f"only one bucket length ran: {set(lens)}")
    for n in set(lens):
        for name in (xk.KERNEL_BF16, xk.KERNEL_DQ, xk.KERNEL_DC):
            want = 2 * lens.count(n)
            got = shapes.get((name, 30, n - 1), 0) + shapes.get((name, n - 1, 30), 0)
            if got != want:
                fail(f"{name} launched {got} times at bucket {n}, expected {want}")
    return trainer, launches


def phase_mlm(tmp: Path, device) -> None:
    """The MLM objective: two deterministic f32 steps of the smoke config
    with mlm.weight 0.5 and text buckets, card vs CPU; then 4 steps at full
    width on the -fast bench config with mlm.weight 0.5."""
    from demovlp_tpu_torch.cli import common
    from demovlp_tpu_torch.train.retrieval import RetrievalTrainer

    cfg = json.loads(SMOKE_CFG.read_text())
    cfg["mlm"] = {"weight": 0.5, "mask_prob": 0.15, "mask_token_id": 103}
    cfg["trainer"]["text_buckets"] = [8, 12, 16]
    phase_train_ref(device, "mlm", cfg)

    cfg = json.loads(FAST_CFG.read_text())
    cfg["mlm"] = {"weight": 0.5, "mask_prob": 0.15, "mask_token_id": 103}
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = common.build_train_model(cfg, device, seed=0)
    trainer = RetrievalTrainer(
        model, common.build_loss(cfg), [], common.build_optimizer(cfg, model.parameters()), cfg,
        tmp / "mlm", device, data_loader=common.init_dataloaders(cfg, train=True)[0],
        tokenizer=common.build_tokenizer_from_config(cfg), max_samples_per_epoch=4 * 128,
        transfer_dtype=torch.bfloat16, fence_steps=True)
    trainer._train_epoch(1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    steps = [round(1e3 * t, 3) for t in trainer.step_times]
    log(f"[mlm] full width, {FAST_CFG.name} with mlm.weight 0.5 (MLM head on "
        f"the 768-wide text tower, 30522-word vocabulary): step ms {steps} at text lengths "
        f"{trainer.step_text_lens}, losses {trainer.step_losses}; peak device memory "
        f"{peak / 2**30:.3f} GiB ({(peak - held) / 2**30:.3f} GiB beyond the "
        f"{held / 2**30:.3f} GiB held before)")
    if len(steps) != 4 or not all(np.isfinite(trainer.step_losses)):
        fail(f"[mlm] expected 4 finite full-width steps, got {trainer.step_losses}")
    del trainer, model


def phase_remat(device) -> None:
    """One full-width step of configs/bench/ab_local_bf16.json with and
    without remat, from the same weights, batch and dropout key (the
    run's seed, step 0, data rank 0): the
    losses and the region tower's gradients (which the recompute feeds)
    must agree."""
    from demovlp_tpu_torch.cli import common
    from demovlp_tpu_torch.train.steps import (batch_to_device, make_retrieval_train_step,
                                               prepare_batch)

    base = json.loads(TRAIN_CFG.read_text())
    dl = common.init_dataloaders(base, train=True)[0][0]
    dl.set_epoch(1)
    data = next(iter(dl))
    tok = common.build_tokenizer_from_config(base)
    res, grads = {}, {}
    for remat in (False, True):
        cfg = dict(base, remat=remat)
        held = torch.cuda.memory_allocated()
        model = common.build_train_model(cfg, device, seed=0)
        step = make_retrieval_train_step(model, common.build_loss(cfg),
                                         common.build_optimizer(cfg, model.parameters()))
        batch = batch_to_device(prepare_batch(data, tok), device, torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = step(batch, float(cfg["optimizer"]["args"]["lr"]))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        res[remat] = dict(loss=float(m["loss"]), peak=torch.cuda.max_memory_allocated() - held,
                          ms=ms, remat=model.object_model.remat)
        grads[remat] = {n: p.grad.detach().float().clone()
                        for n, p in model.object_model.named_parameters() if p.grad is not None}
        del model, step, batch, m
        torch.cuda.empty_cache()
    a, b = res[False], res[True]
    log(f"[remat] one full-width step (f=1, k=30, batch 128, bf16): loss without remat "
        f"{a['loss']:.7f}, with {b['loss']:.7f} (bit-identical: {a['loss'] == b['loss']}); "
        f"peak device memory beyond the model's start {a['peak'] / 2**30:.3f} GiB without, "
        f"{b['peak'] / 2**30:.3f} GiB with; step {a['ms']:.1f} ms without, {b['ms']:.1f} ms with "
        "(first step of a new model: first-use costs included)")
    if not b["remat"] or a["remat"]:
        fail("[remat] the config key did not turn the region tower's remat on and off")
    if not np.isfinite(b["loss"]) or abs(a["loss"] - b["loss"]) > (
            TRAIN_REF_LOSS_RTOL * abs(a["loss"]) + 1e-6):
        fail(f"[remat] losses differ: {a['loss']} vs {b['loss']}")
    ga, gb = grads[False], grads[True]
    if set(ga) != set(gb) or not any(n.startswith("blocks.") for n in ga):
        fail("[remat] the region tower's gradients differ in which parameters they hold")
    worst, same = 0.0, 0
    for name, g in ga.items():
        scale = float(g.abs().max()) or 1.0
        rel = float((gb[name] - g).abs().max()) / scale
        worst = max(worst, rel)
        same += int(torch.equal(g, gb[name]))
        if not (bool(torch.isfinite(gb[name]).all()) and rel <= REMAT_GRAD_RTOL):
            fail(f"[remat] region tower gradient {name}: max |diff| / max |g| {rel} "
                 f"(limit {REMAT_GRAD_RTOL:g})")
    log(f"[remat] region tower gradients, {len(ga)} tensors: {same} bit-identical, worst "
        f"max |diff| / max |g| {worst:.3e} (limit {REMAT_GRAD_RTOL:g})")
    del grads, ga, gb


def phase_query(tmp: Path, cat, device):
    """The query CLI at full width (seeded weights as in [serve]) against
    the index [serve] wrote: 64 queries (the gallery's first captions and
    free text), then one query; card vs CPU on a gallery slice, and the
    single query's scoring card vs CPU over the whole gallery."""
    from demovlp_tpu_torch import serve
    from demovlp_tpu_torch.cli import common
    from demovlp_tpu_torch.cli.query_index import run
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    index = tmp / "emb.npz"
    gallery, meta = serve.load_index(index)
    n_cap = 64 - len(QUERY_FREE_TEXT)
    queries = list(meta["raw_captions"][:n_cap]) + QUERY_FREE_TEXT
    qfile = tmp / "queries.txt"
    qfile.write_text("\n".join(queries) + "\n")
    base = ["-c", str(SERVE_CFG), "--index", str(index), "-k", "10"]
    xk.reset_launch_counts()
    rec = run(base + ["--queries-file", str(qfile), "--output", str(tmp / "query64.json")])
    launches, shapes = dict(xk.LAUNCHES), dict(xk.SHAPE_LAUNCHES)
    xk.reset_launch_counts()
    one = run(base + ["--query", QUERY_FREE_TEXT[0], "--output", str(tmp / "query1.json")])
    launches_one = dict(xk.LAUNCHES)
    n_gal = gallery["g_o"].shape[0]
    log(f"[query] {len(queries)} queries x {n_gal} gallery videos (f = 8, full width, bf16 "
        f"text tower, f32 local sims): {rec['seconds']:.3f} s = "
        f"{len(queries) / rec['seconds']:.1f} queries/s; 1 query x {n_gal}: "
        f"{one['seconds']:.3f} s")
    log(f"[query] kernel launches: 64 queries {launches} by shape {shapes}; one query "
        f"{launches_one}")
    if rec["sims"].shape != (64, n_gal) or one["sims"].shape != (1, n_gal):
        fail(f"query sims of shape {rec['sims'].shape} and {one['sims'].shape}")
    if launches[xk.KERNEL] != 2 or launches_one[xk.KERNEL] != 2:
        fail("a query call launched the f32 forward other than twice (once a direction)")
    if not np.isfinite(rec["sims"]).all() or not np.allclose(one["sims"][0], rec["sims"][-4],
                                                             rtol=0, atol=TOL_QUERY_CARD):
        fail("query sims non-finite, or the single query disagrees with its row of the 64")

    # the gallery's own captions embed as the serve embedded them
    model = common.build_serving_model(json.loads(SERVE_CFG.read_text()), device)
    tok = common.build_tokenizer_from_config(json.loads(SERVE_CFG.read_text()))
    q = serve.embed_texts(serve.make_text_embed_step(model), queries, tok, device)
    for k in ("g_t", "l_t"):
        want = cat[k][:n_cap]
        err = float(np.abs(q[k][:n_cap] - want).max() / np.abs(want).max())
        log(f"[query] the gallery's {n_cap} captions, query path vs serve {k}: max |err| / "
            f"max |value| {err:.3e} (limit {TOL_BF16_CARD:g})")
        if not err <= TOL_BF16_CARD:
            fail(f"[query] text embeddings {k} disagree with the serve's ({err})")
    if not np.array_equal(q["t_mask"][:n_cap], cat["t_mask"][:n_cap]):
        fail("[query] text masks differ from the serve's")

    # card vs CPU on a slice of the gallery
    gal = {k: v[:QUERY_SLICE] for k, v in gallery.items()}
    score = common.local_score_args(json.loads(SERVE_CFG.read_text()))
    step = serve.make_text_embed_step(model)
    _, card_sims = serve.query_retrieval(step, queries, tok, gal, device, k=10, **score)
    cpu_model = common.build_serving_model(json.loads(SERVE_CFG.read_text()), "cpu")
    t0 = time.perf_counter()
    _, cpu_sims = serve.query_retrieval(serve.make_text_embed_step(cpu_model), queries, tok,
                                        gal, "cpu", k=10, **score)
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(card_sims - cpu_sims).max())
    log(f"[query] {len(queries)} x {QUERY_SLICE} slice, card vs CPU query_retrieval (each "
        f"side's own bf16 text tower; CPU {cpu_s:.1f} s): max abs err {err:.3e} (limit "
        f"{TOL_QUERY_CARD:g})")
    if not err <= TOL_QUERY_CARD:
        fail(f"[query] card and CPU query sims disagree ({err})")
    # the scoring alone, on the card's query embeddings: the kernel at the
    # non-square query shape against the CPU's plain version
    q_slice = {k: v for k, v in q.items()}
    got = serve.query_sims(q_slice, gal, device, **score)
    want = serve.query_sims(q_slice, gal, "cpu", **score)
    err_kernel = check_close(f"query sims {len(queries)}x{QUERY_SLICE}, card vs CPU scoring",
                             torch.from_numpy(got), torch.from_numpy(want), score["focal_type"])
    # the single query against the whole gallery (the kernel at Bq = 1), card
    # vs CPU scoring on the card's embedding of it; the CLI's sims beside it
    q1 = serve.embed_texts(step, QUERY_FREE_TEXT[:1], tok, device)
    got1 = serve.query_sims(q1, gallery, device, **score)
    want1 = serve.query_sims(q1, gallery, "cpu", **score)
    err_one = check_close(f"query sims 1x{n_gal}, card vs CPU scoring",
                          torch.from_numpy(got1), torch.from_numpy(want1), score["focal_type"])
    cli_err = float(np.abs(one["sims"] - got1).max())
    log(f"[query] the CLI's single-query sims vs the card's scoring of the same query: max "
        f"abs err {cli_err:.3e} (limit {TOL_QUERY_CARD:g})")
    if not cli_err <= TOL_QUERY_CARD:
        fail(f"[query] the CLI's single-query sims disagree with the card's scoring ({cli_err})")
    err_kernel = max(err_kernel, err_one)
    del model, cpu_model
    return dict(launches=launches[xk.KERNEL], err=err_kernel, q=q, gallery=gallery,
                seconds=rec["seconds"])


def phase_predict_qa(tmp: Path, device, qa_trainer) -> None:
    """The predict CLI with the [qa] phase's checkpoint over
    qa_synthetic_f8.json's test split, against the argmax of the QA
    trainer's own eval logits for the same weights."""
    from demovlp_tpu_torch.cli.predict_qa import run
    from demovlp_tpu_torch.train.steps import batch_to_device, pad_batch, prepare_batch

    ckpt = qa_trainer.checkpoint.save_dir / "checkpoint-epoch1.pth"
    out = tmp / "predictions.json"
    rec = run(["-c", str(QA_CFG), "-r", str(ckpt), "--output", str(out)])[0]
    dl = qa_trainer.valid_data_loader[0]
    want = {}
    for data in dl:
        arrays = prepare_batch(data, qa_trainer.tokenizer)
        arrays.pop("label", None)
        arrays, n = pad_batch(arrays, dl.batch_size)
        logits = qa_trainer._eval_step(batch_to_device(arrays, qa_trainer.device,
                                                       qa_trainer.transfer_dtype))
        for qid, p in zip(data["question_id"], torch.argmax(logits[:n], -1).cpu().tolist()):
            want[int(qid)] = p
    got = {r["question_id"]: r["answer"] for r in rec["results"]}
    written = json.loads(out.read_text())
    label2ans = dl.dataset.label2ans
    log(f"[predict-qa] {len(got)} questions (f = 8, full width, bf16, 1500 answers) from "
        f"{ckpt.name}: {rec['seconds']:.3f} s = {len(got) / rec['seconds']:.1f} questions/s; "
        f"equal to the trainer's own argmax: {got == want}; distinct answers "
        f"{len(set(got.values()))}")
    if len(written) != len(dl.dataset) or sorted(got) != sorted(want):
        fail(f"[predict-qa] {len(written)} predictions for {len(dl.dataset)} questions")
    if got != want or any(r["answer_text"] != label2ans[r["answer"]] for r in written):
        fail("[predict-qa] the predictions differ from the QA trainer's own argmax")


def _bound(flops: float, nbytes: float, peak: float):
    op_ms, byte_ms = 1e3 * flops / peak, 1e3 * nbytes / PEAK_BYTES
    return max(op_ms, byte_ms), ("operations" if op_ms >= byte_ms else "bytes")


def _mode_peak(bf16: bool):
    """(effective peak, text) for the operation bound of a kernel mode: bf16
    products at the bf16 tensor-core peak; f32 as TF32_PASSES TF32 passes
    at the TF32 peak, with the f32 FFMA peak's bound named beside it."""
    if bf16:
        return PEAK_BF16_FLOPS, f"{PEAK_BF16_FLOPS:.3g}/s bf16"
    return PEAK_TF32_FLOPS / TF32_PASSES, (f"{TF32_PASSES} x TF32 at {PEAK_TF32_FLOPS:.3g}/s; "
                                           f"f32 FFMA {PEAK_F32_FLOPS:.3g}/s")


def _kernel_names(fn, attempts: int = 3) -> list:
    """Names of the CUDA kernels one call of fn launches, from the profiler.
    A session that records no device activity at all is the profiler's
    collection failing, not fn (seen now and then on a session that
    follows another closely), so fn runs again under a new session, up to
    `attempts` sessions; the callers still fail unless the kernel is seen."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages()
                        if str(getattr(e, "device_type", "")).endswith("CUDA")})
        if names:
            break
        log(f"[profile] session {attempt + 1} of {attempts} recorded no device activity")
    return names


def phase_timing_train(inputs, focal_equal: bool, bf16: bool, tag: str, device,
                       profile: bool = True):
    """The forward and the two backward kernels on a train run's first
    batch's local embeddings (rounded to bf16 in bf16 mode, as the loss
    rounds them), with a seeded cotangent; per train step each runs once a
    direction. With `profile` the profiler must see the kernels run (the
    launch counts show it where that is off). Rows keyed by kernel name."""
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    rnd = xk.round_bf16 if bf16 else (lambda t: t)
    l_o, l_t = rnd(inputs["l_o"]), rnd(inputs["l_t"])
    o_m, t_m = inputs["o_mask"], inputs["t_mask"]
    eq = focal_equal
    peak, peak_text = _mode_peak(bf16)
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
        if bf16 and profile:
            names = _kernel_names(lambda: [xk.direction_sim(ctx, qry, cm, 20.0, eq, True)
                                           for _ in range(2)])
            log(f"[timing] {tag} bf16 forward {direction}: S = "
                f"{xk.bf16_forward_splits(bc, bq, ls, lq, d)}; profiler: device kernels {names}")
            if not any("xattn_sim_fwd_bf16_kernel" in n for n in names):
                fail(f"the profiler did not see xattn_sim_fwd_bf16_kernel run: {names}")
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
            ffma = "" if bf16 else f"; f32 FFMA bound {1e3 * flops / PEAK_F32_FLOPS:.4f} ms"
            log(f"[timing] {tag} {name} {direction} {bc}x{bq} Ls={ls} Lq={lq} D={d}: kernel "
                f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {by} "
                f"({flops:.3e} flop at {peak_text}, {nbytes:.3e} B{ffma}), "
                f"{flops / ms / 1e9:.2f} TFLOP/s achieved")
        splits = {k: xk.backward_plan(k, ctx, qry, bf16) for k in (xk.KERNEL_DQ, xk.KERNEL_DC)}
        seen = ""
        if profile:
            # two calls: a trace can miss a kernel of a single call (the
            # launch counts, not the profiler, show that the kernels ran)
            names = _kernel_names(lambda: [xk.direction_sim_bwd(*bargs) for _ in range(2)])
            unseen = [k + sfx for k in (xk.KERNEL_DQ, xk.KERNEL_DC)
                      for sfx in ("_kernel", "_reduce_kernel")
                      if not any(k + sfx + "<" in n or k + sfx + "(" in n for n in names)]
            seen = f"; profiler: device kernels {names}" + (
                f"; not in the trace: {unseen}" if unseen else "")
        log(f"[timing] {tag} backward {direction}: (S, slots) d_query {splits[xk.KERNEL_DQ]}, "
            f"d_context {splits[xk.KERNEL_DC]}{seen}")
        for k in (xk.KERNEL_DQ, xk.KERNEL_DC):
            rows[k].setdefault("splits", []).append(splits[k][0])
    for name, r in rows.items():
        prev = PREV_BWD_MS.get((tag, name))
        prev = (f"; one block an item (S = 1, no reduce) {prev} ms, now S = {r['splits']}"
                if prev else "")
        if f"{name} {tag}" in PREV_MS:
            prev = f"; previous design (FFMA, a block a pair) {PREV_MS[f'{name} {tag}']} ms"
        log(f"[timing] {tag} {name}: {r['ms']:.3f} ms per step (two launches, "
            f"{r['ms'] / 2:.3f} ms per launch), plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}{prev}")
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
    path = ak.kernel_path(torch.bfloat16, 64)
    kernel_name = {ak.MMA: "grouped_attention_mma_kernel", ak.FFMA: "grouped_attention_kernel"}
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
        prev = f", previous design {PREV_MS['grouped_attention full']} ms" if name == "full" else ""
        log(f"[timing] grouped_attention {name} G={g} Lq={lq} Lk={lk} hd={hd} bf16: kernel "
            f"{ms:.4f} ms ({kernel_name[path]}{prev}), "
            f"plain {plain_ms:.4f} ms, scaled_dot_product_attention {lib_ms:.4f} ms "
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
        f"ms ({kernel_name[path]}; previous design "
        f"{PREV_MS['grouped_attention four shapes']} ms), plain {total['plain_ms']:.4f} ms, "
        f"scaled_dot_product_attention {total['library_ms']:.4f} ms, bound "
        f"{total['bound_ms']:.4f} ms")
    q, k, v, b = _attn_inputs(ATTN_SHAPES["full"], torch.bfloat16, device, seed=20)
    names = _kernel_names(lambda: ak.grouped_attention(q, k, v, b))
    log(f"[timing] grouped_attention full bf16, profiler: device kernels {names}")
    if not any(kernel_name[path] in n for n in names):
        fail(f"the profiler did not see {kernel_name[path]} run: {names}")
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


def _region_video(args):
    """One video's frame files; (bytes written, compressed files)."""
    root, vid, seed, first = args
    rng = np.random.default_rng(seed)
    path = root / vid
    path.mkdir(parents=True, exist_ok=True)
    nbytes, packed = 0, 0
    for f in range(int(rng.integers(RD_FRAMES[0], RD_FRAMES[1] + 1))):
        n = int(rng.integers(RD_REGIONS[0], RD_REGIONS[1] + 1))
        w, h = int(rng.integers(320, 1281)), int(rng.integers(240, 721))
        x1, y1 = rng.uniform(0, w / 2, n), rng.uniform(0, h / 2, n)
        bbox = np.stack([x1, y1, x1 + rng.uniform(1, w / 2, n), y1 + rng.uniform(1, h / 2, n)],
                        axis=1).astype(np.float32)
        # distinct confidences: the native reader and numpy order ties apart
        info = {"objects_conf": ((rng.permutation(n) + 0.5) / n).astype(np.float32),
                "objects_id": rng.integers(0, 1600, n), "image_w": w, "image_h": h}
        x = np.abs(rng.standard_normal((n, 2048), dtype=np.float32))
        compressed = (first + f) % 8 == 0
        (np.savez_compressed if compressed else np.savez)(path / f"{f}.npz", x=x, bbox=bbox,
                                                          info=info)
        nbytes += (path / f"{f}.npz").stat().st_size
        packed += compressed
    return nbytes, packed


def _realdata_inputs(tree: Path):
    """The first RD_ROWS rows of the committed MSVD split files under
    tree/meta, and the region tree of their videos under tree/objects."""
    meta, objects = tree / "meta", tree / "objects"
    meta.mkdir()
    vids = []
    for name, rows in RD_ROWS.items():
        lines = (ROOT / "meta_data" / name).read_text().splitlines(keepends=True)[:rows]
        (meta / name).write_text("".join(lines))
        vids += [line.rstrip("\n").split("\t")[1] for line in lines]
    vids = list(dict.fromkeys(vids))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        sizes = list(pool.map(_region_video, [(objects, v, RD_SEED * 100003 + i, i)
                                              for i, v in enumerate(vids)]))
    nbytes, packed = sum(b for b, _ in sizes), sum(c for _, c in sizes)
    files = sum(1 for _ in objects.rglob("*.npz"))
    return meta, objects, dict(videos=len(vids), files=files, compressed=packed, bytes=nbytes,
                               seconds=time.perf_counter() - t0)


def _loader_alone(cfg, card: str, numpy_reader: bool):
    """RD_LOADER_BATCHES train batches of the config's loader, no model:
    (seconds, a digest a batch)."""
    import hashlib

    from demovlp_tpu_torch.data.loader import MultiDistTextObjectVideoDataLoader

    old = os.environ.get("DEMOVLP_NATIVE")
    if numpy_reader:
        os.environ["DEMOVLP_NATIVE"] = "0"
    try:
        dl = MultiDistTextObjectVideoDataLoader(**cfg["data_loader"]["args"])
        dl.set_epoch(1)
        digests = []
        t0 = time.perf_counter()
        for data in dl:
            digests.append(hashlib.sha256(data["object"].tobytes() +
                                          data["object_mask"].tobytes()).hexdigest())
            if len(digests) == RD_LOADER_BATCHES:
                break
        secs = time.perf_counter() - t0
    finally:
        if old is None:
            os.environ.pop("DEMOVLP_NATIVE", None)
        else:
            os.environ["DEMOVLP_NATIVE"] = old
    b, f = dl.batch_size, dl.dataset.segments
    path = "numpy per-sample" if numpy_reader else "native whole-batch"
    log(f"[realdata] ({card}) loader alone, {path} path, {dl.num_workers} workers: "
        f"{len(digests)} batches of {b} x {f} frames in {secs:.3f} s: "
        f"{len(digests) / secs:.2f} batches/s, {len(digests) * b * f / secs:.1f} frames/s")
    return secs, digests


def _data_inclusive_ms(trainer, steps: int = 16) -> float:
    """ms a train step with the data: one more epoch's first `steps` steps,
    from the loader's first batch to the card's last result (host decode,
    tokenize, transfer and step, as the trainer runs them)."""
    from demovlp_tpu_torch.train.steps import batch_to_device, prepare_batch

    dl = trainer.data_loader[0]
    dl.set_epoch(3)
    lr = trainer.current_lr(1)
    n = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for data in dl:
        trainer._train_step(batch_to_device(prepare_batch(data, trainer.tokenizer),
                                            trainer.device, trainer.transfer_dtype), lr)
        n += 1
        if n == steps:
            break
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def phase_realdata(tmp: Path, device, card: str, pretrain, ft_trainer):
    """The train CLI on configs/ft/msvd_o2t-select.json: real MSVD ids and
    captions through MSVDObjectSelect, regions from a seeded npz tree
    through the native whole-batch decode, from the train phase's f = 1
    checkpoint. Returns (trainer, launches, the first batch's local inputs)."""
    from demovlp_tpu_torch.cli.train import run
    from demovlp_tpu_torch.data import native
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    phase_t0 = time.perf_counter()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build, prefix="realdata-") as tree:
        meta, objects, made = _realdata_inputs(Path(tree))
        log(f"[realdata] region tree: {made['videos']} videos, {made['files']} frame files "
            f"({made['compressed']} np.savez_compressed), {made['bytes'] / 2**30:.3f} GiB on disk, "
            f"written in {made['seconds']:.1f}s")
        if made["bytes"] >= 2 * 2**30:
            fail(f"the region tree takes {made['bytes']} bytes, over 2 GiB")
        cfg = json.loads(MSVD_CFG.read_text())
        args = cfg["arch"]["args"]
        args["text_params"].update(model="", pretrained=False)
        args["load_checkpoint"] = str(pretrain.checkpoint.save_dir / "checkpoint-epoch1.pth")
        dl_args = cfg["data_loader"]["args"]
        workers = min(int(dl_args["num_workers"]), os.cpu_count() or 1)
        dl_args.update(object_dir=str(objects), num_workers=workers)
        cfg["trainer"].update(epochs=1, max_samples_per_epoch=512, save_dir=str(tmp / "realdata"))
        log(f"[realdata] reduced: {MSVD_CFG.relative_to(ROOT)} with text_params.model '' and "
            f"pretrained false (no DistilBERT in the repo: random-init text tower, full width); "
            f"load_checkpoint = the train phase's f = 1 checkpoint (temporal embed inflated, "
            f"zeros); epochs 1, max_samples_per_epoch 512 (16 steps of "
            f"{dl_args['batch_size']}); save_dir under the run's temporary directory; "
            f"object_dir = the seeded region tree; DEMOVLP_META_DIR = the first "
            f"{RD_ROWS['MSVD_train.tsv']} rows of meta_data/MSVD_train.tsv and "
            f"{RD_ROWS['MSVD_test.tsv']} of meta_data/MSVD_test.tsv; num_workers "
            f"{workers} (config 16, {os.cpu_count()} CPUs)")
        path = tmp / "realdata.json"
        path.write_text(json.dumps(cfg))
        os.environ["DEMOVLP_META_DIR"] = str(meta)
        try:
            built = not native.library_path().exists()
            t0 = time.perf_counter()
            reader = native.get_native_reader()
            if reader.path.parent != ROOT / "build" / "native":
                fail(f"the native reader was not built from the port's copy: {reader.path}")
            log(f"[realdata] native reader {reader.path.relative_to(ROOT)} from "
                f"{native.SRC.relative_to(ROOT)}, "
                + (f"built by g++ in {time.perf_counter() - t0:.1f}s" if built else
                   "found already built") + f", {reader.n_threads} threads")
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            native.reset_stats()
            xk.reset_launch_counts()
            t0 = time.perf_counter()
            trainer = run(["-c", str(path)], fence_steps=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, stats = dict(xk.LAUNCHES), dict(native.STATS)
            peak = torch.cuda.max_memory_allocated()
            train_ds = trainer.data_loader[0].dataset
            val_ds = trainer.valid_data_loader[0].dataset
            resamples = train_ds.resample_count + val_ds.resample_count
            inputs = _first_batch_local(trainer)
            rd_ms = _data_inclusive_ms(trainer)
            ft_ms = _data_inclusive_ms(ft_trainer)
            native_s, native_digests = _loader_alone(cfg, card, numpy_reader=False)
            numpy_s, numpy_digests = _loader_alone(cfg, card, numpy_reader=True)
        finally:
            os.environ.pop("DEMOVLP_META_DIR", None)
    steps, losses, log_ = trainer.step_times, trainer.step_losses, trainer.final_log
    batch, f = trainer.data_loader[0].batch_size, train_ds.segments
    step_ms = 1e3 * float(np.median(steps[1:]))
    ft_step_ms = 1e3 * float(np.median(ft_trainer.step_times[1:]))
    n_val = int(bool(cfg["trainer"].get("init_val", True))) + cfg["trainer"]["epochs"]
    want_frames = len(steps) * batch * f + n_val * len(val_ds) * f
    log(f"[realdata] ({card}) {len(steps)} steps of {batch} ({type(train_ds).__name__}, f={f}, "
        f"k=30, bf16 towers, f32 local loss, full width): median step {step_ms:.3f} ms over "
        f"steps 2-{len(steps)} (card fenced after each step; decode, tokenize and transfer "
        f"outside the fence), {batch / step_ms * 1e3:.1f} pairs/s; the [finetune] phase's "
        f"synthetic median in this call {ft_step_ms:.3f} ms; step 1 {1e3 * steps[0]:.3f} ms; "
        f"wall with two validations and checkpoint {wall:.1f}s")
    log(f"[realdata] ({card}) a step with its data (16 steps of one more epoch, from the "
        f"loader's first batch to the card's last result): real data {rd_ms:.3f} ms, "
        f"synthetic ([finetune] trainer) {ft_ms:.3f} ms, difference {rd_ms - ft_ms:.3f} ms")
    log(f"[realdata] ({card}) peak device memory {peak / 2**30:.3f} GiB, of which "
        f"{held / 2**30:.3f} GiB held before the run (earlier phases' trainers): "
        f"{(peak - held) / 2**30:.3f} GiB the run's own")
    log(f"[realdata] step ms: {[round(1e3 * t, 3) for t in steps]}")
    log(f"[realdata] loss at step 1 {losses[0]:.6f}, at step {len(losses)} {losses[-1]:.6f}")
    log(f"[realdata] kernel launches in this run (train steps and validation): {launches}")
    log(f"[realdata] native reader: {stats['frames_native']} frames decoded natively "
        f"(expected {want_frames}: {len(steps)} x {batch} x {f} train, {n_val} validations "
        f"x {len(val_ds)} x {f}), rows redone per sample {stats['rows_redone']}, "
        f"resample_count {resamples}")
    log(f"[realdata] val over {len(val_ds)} test videos: R@1 {log_['val_0_t2v_metrics_R1']}, "
        f"R@5 {log_['val_0_t2v_metrics_R5']}, R@10 {log_['val_0_t2v_metrics_R10']} (t2v); "
        f"v2t R@1 {log_['val_0_v2t_metrics_R1']}")
    log(f"[realdata] ({card}) loader alone: native whole-batch {native_s:.3f} s, numpy "
        f"per-sample {numpy_s:.3f} s for {RD_LOADER_BATCHES} batches "
        f"({numpy_s / native_s:.2f}x); the two paths' batches identical: "
        f"{native_digests == numpy_digests}")
    if type(train_ds).__name__ != "MSVDObjectSelect" or len(val_ds) != RD_ROWS["MSVD_test.tsv"]:
        fail(f"expected MSVDObjectSelect over {RD_ROWS['MSVD_test.tsv']} test videos, got "
             f"{type(train_ds).__name__} over {len(val_ds)}")
    if len(steps) != 16:
        fail(f"expected 16 real-data steps, got {len(steps)}")
    if not all(np.isfinite(losses)):
        fail(f"non-finite real-data loss: {losses}")
    if stats["frames_native"] != want_frames or stats["rows_redone"] != 0:
        fail(f"the native whole-batch decode did not decode the batches: {stats}, expected "
             f"{want_frames} frames")
    for k in (xk.KERNEL, xk.KERNEL_DQ, xk.KERNEL_DC):
        if launches[k] < 32:
            fail(f"{k} launched {launches[k]} times in 16 real-data steps (2 a step expected)")
    for k in ("R1", "R5", "R10"):
        if not np.isfinite(log_[f"val_0_t2v_metrics_{k}"]):
            fail(f"non-finite validation R@{k[1:]}: {log_}")
    if native_digests != numpy_digests or len(native_digests) != RD_LOADER_BATCHES:
        fail("the native whole-batch and numpy per-sample loaders gave different batches")
    log(f"[realdata] phase wall {time.perf_counter() - phase_t0:.1f}s (tree, build, run, "
        f"timings, removal)")
    return trainer, launches, inputs


def _read_scalars(log_dir: Path) -> list:
    return [json.loads(line) for line in (log_dir / "scalars.jsonl").read_text().splitlines()]


def _epoch_with_writer(trainer, writer, epoch: int):
    """One more epoch of `trainer`'s train loop (16 steps, fenced, no
    validation) with `writer` as its scalar writer (None: none); (fenced
    step seconds, the synchronising calls torch's sync debug mode reported
    in the loop)."""
    import warnings

    trainer.writer, trainer.do_validation = writer, False
    trainer.step_times, trainer.step_losses, trainer.step_text_lens = [], [], []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trainer._train_epoch(epoch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    return trainer.step_times, syncs


def _trainer_state(trainer) -> dict:
    """Copies of what a train epoch changes in `trainer`: its weights, its
    optimizer's state, the torch and MLM generators and the run's record."""
    import copy

    return dict(
        model={k: v.detach().clone() for k, v in trainer.model.state_dict().items()},
        opt={p: {k: v.clone() if torch.is_tensor(v) else v for k, v in st.items()}
             for p, st in trainer.optimizer.state.items()},
        rng=(torch.get_rng_state(), torch.cuda.get_rng_state_all(),
             copy.deepcopy(trainer._mlm_rng)),
        record=(trainer.writer, trainer.do_validation, trainer.step_times,
                trainer.step_losses, trainer.step_text_lens))


def _restore_trainer_state(trainer, saved: dict) -> None:
    """Put `_trainer_state`'s copies back, in place: the optimizer's state
    tensors keep their dtypes (a bf16 first moment stays bf16)."""
    trainer.model.load_state_dict(saved["model"])
    with torch.no_grad():
        for p, st in saved["opt"].items():
            for k, v in st.items():
                if torch.is_tensor(v):
                    trainer.optimizer.state[p][k].copy_(v)
                else:
                    trainer.optimizer.state[p][k] = v
    cpu_rng, cuda_rng, trainer._mlm_rng = saved["rng"]
    torch.set_rng_state(cpu_rng)
    torch.cuda.set_rng_state_all(cuda_rng)
    (trainer.writer, trainer.do_validation, trainer.step_times, trainer.step_losses,
     trainer.step_text_lens) = saved["record"]


def phase_record(tmp: Path, trainer) -> None:
    """The [train] run's record under <save_dir>/log/<name>/<stamp>/: one
    train/loss_train_0 a step at steps 1..16 equal to the trainer's own
    losses, loss_val_0 after validation, info.log; then the same 16 steps
    (epoch 1's batches again) with the writer and without it, fenced, and
    the synchronising calls in each loop counted by torch's sync debug
    mode, which must be the same. The trainer's weights, optimizer state,
    generators and record are put back after, so later phases read the
    [train] run as it ended."""
    from demovlp_tpu_torch.utils.writer import MetricsWriter

    log_dir = trainer.writer.log_dir
    recs = _read_scalars(log_dir)
    train = [(r["step"], r["value"]) for r in recs if r["tag"] == "train/loss_train_0"]
    val = [r for r in recs if r["tag"].endswith("loss_val_0")]
    info = log_dir / "info.log"
    log(f"[record] {log_dir.relative_to(tmp)}: {len(recs)} records, tags "
        f"{sorted({r['tag'] for r in recs})}; info.log {info.stat().st_size if info.exists() else 0} "
        f"bytes; TensorBoard sink {'attached' if trainer.writer._tb is not None else 'absent'}")
    if train != list(zip(range(1, RECORD_STEPS + 1), trainer.step_losses)):
        fail(f"train/loss_train_0 records {train} are not steps 1..{RECORD_STEPS} with the "
             f"trainer's losses {trainer.step_losses}")
    if not val or val[-1]["step"] != RECORD_STEPS or \
            val[-1]["value"] != trainer.final_log["val_loss_0"]:
        fail(f"no loss_val_0 record of the validation at step {RECORD_STEPS}: {val}")
    if not info.exists() or "val_loss_0" not in info.read_text():
        fail(f"{info} is missing or does not hold the epoch log")
    if not (tmp / "train" / "web" / trainer.config["name"] / log_dir.name).is_dir():
        fail("the run's web directory was not created")
    saved = _trainer_state(trainer)
    step_count = trainer.optimizer.step_count
    rows = {}
    for name in ("with the writer", "without"):
        writer = MetricsWriter(tmp / "record-writer") if name == "with the writer" else None
        steps, syncs = _epoch_with_writer(trainer, writer, 1)
        if writer is not None:
            writer.close()
            logged = [r for r in _read_scalars(tmp / "record-writer")
                      if r["tag"] == "train/loss_train_0"]
            if len(logged) != RECORD_STEPS:
                fail(f"the writer took {len(logged)} train losses in {RECORD_STEPS} steps")
        ms = [1e3 * t for t in steps[1:]]
        rows[name] = (float(np.median(ms)), min(ms), max(ms), syncs)
        log(f"[record] {RECORD_STEPS} steps {name}: fenced median {rows[name][0]:.3f} ms over "
            f"steps 2-{len(steps)} (spread {rows[name][1]:.3f}-{rows[name][2]:.3f}); "
            f"synchronising calls reported in the loop: {syncs}")
    _restore_trainer_state(trainer, saved)
    if trainer.optimizer.step_count != step_count:
        fail(f"the optimizer's step count is {trainer.optimizer.step_count} after the state was "
             f"put back, not {step_count}")
    (med_w, lo_w, hi_w, sync_w), (med_n, lo_n, hi_n, sync_n) = rows.values()
    log(f"[record] median with the writer {med_w:.3f} ms within the run without it's spread: "
        f"{lo_n <= med_w <= hi_n}; without within with's: {lo_w <= med_n <= hi_w}")
    if sync_w != sync_n:
        fail(f"the writer changed the loop's synchronising calls: {sync_w} with, {sync_n} without")


def _profile_window(trainer, device, prof_dir: Path, batches, label: str) -> None:
    """One traced window: a step before it (so it opens on a running loop),
    then PROFILE_STEPS unfenced steps whose host pieces sit in annotate
    spans, the batches drawn from `batches` inside the `data` span; the
    trace's split by span, its top host ops and device kernels, the
    device's busy share and its longest idle gaps."""
    import gzip
    import shutil

    from demovlp_tpu_torch.train.async_metrics import DeferredMetrics
    from demovlp_tpu_torch.train.steps import batch_to_device
    from demovlp_tpu_torch.utils import profiling

    lr = trainer.current_lr(1)
    reads = []
    deferred = DeferredMetrics(lambda m: reads.append(float(m["loss"])))
    batch = batch_to_device(trainer.train_arrays(next(batches)), trainer.device,
                            trainer.transfer_dtype)
    deferred.push(trainer._train_step(batch, lr))
    with profiling.trace(prof_dir, device) as prof:
        for _ in range(PROFILE_STEPS):
            with profiling.annotate("data"):
                data = next(batches)
            with profiling.annotate("prepare"):
                arrays = trainer.train_arrays(data)
            with profiling.annotate("to_device"):
                batch = batch_to_device(arrays, trainer.device, trainer.transfer_dtype)
            with profiling.annotate("step"):
                m = trainer._train_step(batch, lr)
            with profiling.annotate("consume"):
                deferred.push(m)
        with profiling.annotate("consume"):
            deferred.flush()
        torch.cuda.synchronize()
    path = prof_dir / profiling.TRACE_FILE
    events = json.loads(path.read_text())["traceEvents"]
    with open(path, "rb") as src, gzip.open(str(path) + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    path.unlink()
    tag = f"[profile] {label}:"
    if len(reads) != PROFILE_STEPS + 1 or not all(np.isfinite(reads)):
        fail(f"{tag} losses {reads}")
    spans = [e for e in events if e.get("cat") == "user_annotation" and e["name"] in PROFILE_SPANS]
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("cat") in TRACE_DEVICE_CATS)
    if len(spans) != len(PROFILE_SPANS) * PROFILE_STEPS + 1 or not dev:
        fail(f"{tag} the trace holds {len(spans)} spans and {len(dev)} device events")
    t0 = min(e["ts"] for e in spans)
    t1 = max(e["ts"] + e["dur"] for e in spans)
    window = t1 - t0
    log(f"{tag} {PROFILE_STEPS} unfenced steps: window {window / 1e3:.3f} ms, "
        f"{window / 1e3 / PROFILE_STEPS:.3f} ms a step; trace "
        f"{os.path.relpath(str(path) + '.gz', ROOT)}")
    for name in PROFILE_SPANS:
        durs = [e["dur"] / 1e3 for e in spans if e["name"] == name]
        log(f"{tag} span {name:9s}: mean {np.mean(durs):9.3f} ms host, "
            f"{len(durs)} spans, {sum(durs) / (window / 1e3):.3f} of the window")
    host = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA") or e.key in PROFILE_SPANS:
            continue
        host.append((e.self_cpu_time_total / 1e3, e.count, e.key))
    host.sort(reverse=True)
    log(f"{tag} host ops with the most self CPU time (the window's {PROFILE_STEPS + 1} step "
        "launches and reads):")
    for ms, count, key in host[:10]:
        log(f"{tag}   {ms:9.3f} ms  x{count:<5d} {key[:100]}")
    by_kernel = {}
    for a, b, name in dev:
        by_kernel[name] = by_kernel.get(name, 0.0) + (b - a) / 1e3
    log(f"{tag} device kernels and copies with the most time:")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]:
        log(f"{tag}   {ms:9.3f} ms  {name[:100]}")
    merged = []
    for a, b, _ in dev:
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    edges = [t0] + [x for ab in merged for x in ab] + [t1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]), reverse=True)
    log(f"{tag} device busy {busy / 1e3:.3f} ms of {window / 1e3:.3f} ms: busy share "
        f"{busy / window:.3f}; {len(gaps)} idle gaps, {sum(g[0] for g in gaps) / 1e3:.3f} ms idle")
    for dur, a, b in gaps[:5]:
        overlap = {}
        for e in spans:
            o = min(b, e["ts"] + e["dur"]) - max(a, e["ts"])
            if o > 0:
                overlap[e["name"]] = overlap.get(e["name"], 0.0) + o / 1e3
        where = ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(overlap.items(),
                                                                key=lambda kv: -kv[1]))
        log(f"{tag}   idle gap {dur / 1e3:8.3f} ms at +{(a - t0) / 1e3:.3f} ms; host in: "
            f"{where or 'no span'}")


def phase_profile(trainer, device, out_dir: Path) -> None:
    """profiling.trace over PROFILE_STEPS unfenced steps of the pre-training
    trainer, the loop's host pieces in annotate spans (the JAX
    trainer has no spans of its own), twice: with the loader drawing the
    next batches on its thread during the window (as training runs), and
    with the window's batches drawn before it (the loader's thread done),
    which shows what the host's own pieces cost without it; then the
    card's memory over the two windows (profiling.device_memory_stats)."""
    from demovlp_tpu_torch.utils import profiling

    dl = trainer.data_loader[0]
    lens = list(trainer.step_text_lens)  # the run's record; train_arrays appends
    torch.cuda.reset_peak_memory_stats(device)
    dl.set_epoch(3)
    batches = iter(dl)
    _profile_window(trainer, device, out_dir / "profile", batches, "loader drawing")
    batches.close()
    dl.set_epoch(4)
    batches = iter(dl)
    drawn = [next(batches) for _ in range(PROFILE_STEPS + 1)]
    batches.close()
    _profile_window(trainer, device, out_dir / "profile-loader-idle", iter(drawn), "loader idle")
    trainer.step_text_lens = lens
    stats = profiling.device_memory_stats()[f"cuda:{torch.device(device).index or 0}"]
    log(f"[profile] the card's memory over the two windows: peak allocated "
        f"{stats['allocated_bytes.all.peak'] / 2**30:.3f} GiB, reserved "
        f"{stats['reserved_bytes.all.current'] / 2**30:.3f} GiB, "
        f"{stats['num_alloc_retries']} allocator retries")


def _widths(model) -> dict:
    """The model's widths in retrieval_step_flops_model's terms."""
    om, tc = model.object_model, model.text_model.config
    return dict(proj_dim=om.proj.out_features, obj_depth=len(om.blocks),
                obj_dim=om.cls_token.shape[-1], text_layers=tc.n_layers, text_dim=tc.dim)


def phase_mfu(card: str, device, trainers: dict) -> None:
    """Model FLOPs a step (utils/flops.retrieval_step_flops_model at each
    run's shapes and widths) and MFU of each fenced median against the
    card's bf16 peak, a text length at a time (step 1 left out where its
    length has others); beside them FlopCounterMode's count of one more
    pre-training step (aten ops only: the local-loss kernels, called
    through ctypes, are not seen) against the model's tower and global-sims
    part."""
    from demovlp_tpu_torch.train.steps import batch_to_device, prepare_batch
    from demovlp_tpu_torch.utils import flops

    peak = flops.peak_bf16_flops(device)
    log(f"[mfu] {card}: dense bf16 peak {peak} FLOP/s (utils/flops.py)")
    if peak is None:
        fail(f"no bf16 peak for {torch.cuda.get_device_name(device)}")
    for tag, trainer in trainers.items():
        obj = trainer.config["arch"]["args"]["object_params"]
        b = trainer.data_loader[0].batch_size
        frames, regions = int(obj["num_frames"]), int(obj["object_num"])
        widths = _widths(trainer.model)
        lens, steps = trainer.step_text_lens, trainer.step_times
        for length in sorted(set(lens)):
            times = [t for i, (n, t) in enumerate(zip(lens, steps))
                     if n == length and i > 0] or [steps[0]]
            model_flops = flops.retrieval_step_flops_model(b, frames, regions, length, **widths)
            sec = float(np.median(times))
            log(f"[mfu] {tag} (batch {b}, f = {frames}, k = {regions}, text {length}): "
                f"{model_flops:.4e} model FLOP a step, fenced median {1e3 * sec:.3f} ms over "
                f"{len(times)} steps: {model_flops / sec:.4e} FLOP/s, MFU "
                f"{flops.mfu(model_flops / sec, device):.4f}")
    trainer = trainers["train"]
    dl = trainer.data_loader[0]
    dl.set_epoch(1)
    batch = batch_to_device(prepare_batch(next(iter(dl)), trainer.tokenizer), trainer.device,
                            trainer.transfer_dtype)
    counted = flops.step_flops(trainer._train_step, batch, trainer.current_lr(1))
    torch.cuda.synchronize()
    b, length = batch["input_ids"].shape
    obj = trainer.config["arch"]["args"]["object_params"]
    shape = (b, int(obj["num_frames"]), int(obj["object_num"]), length)
    widths = _widths(trainer.model)
    towers = flops.retrieval_step_flops_model(*shape, use_local=False, **widths)
    log(f"[mfu] FlopCounterMode over one pre-training step: {counted:.4e} FLOP (aten ops); the "
        f"model's towers and global sims {towers:.4e} (ratio {counted / towers:.4f}); the model "
        f"with the local loss {flops.retrieval_step_flops_model(*shape, **widths):.4e}")
    if counted <= 0:
        fail("FlopCounterMode counted no FLOP in a train step")


def _match_regions(got: dict, want: dict, grid) -> tuple:
    """Two extractor outputs (CPU tensors) matched frame by frame by patch
    (from the geometry's x1, y1): (max |object diff| over the patches both
    selected / max |want object|, the confidence gap each slot crosses
    whose patch sits elsewhere on the other side or not at all)."""
    gh, gw = grid
    k = got["conf"].shape[-1]

    def patches(o):
        return (torch.round(o[..., 2049] * gh) * gw + torch.round(o[..., 2048] * gw)).long()

    pg, pw = patches(got["object"]).reshape(-1, k), patches(want["object"]).reshape(-1, k)
    cg, cw = got["conf"].reshape(-1, k), want["conf"].reshape(-1, k)
    og = got["object"].reshape(pg.shape[0], k, -1)
    ow = want["object"].reshape(pg.shape[0], k, -1)
    err, gaps = 0.0, []
    for r in range(pg.shape[0]):
        slot_w = {p: s for s, p in enumerate(pw[r].tolist())}
        for s, p in enumerate(pg[r].tolist()):
            s2 = slot_w.get(p)
            if s2 is None:  # kept on one side only: a tie at the cut
                gaps.append(abs(float(cg[r, s] - cw[r, -1])))
                continue
            err = max(err, float((og[r, s] - ow[r, s2]).abs().max()))
            if s2 != s:
                gaps.append(max(abs(float(cg[r, s] - cw[r, s2])),
                                abs(float(cw[r, s] - cw[r, s2]))))
    return err / float(want["object"].abs().max()), gaps


def _video_frames(seed: int, index: int, n: int, frames: int, size: int) -> np.ndarray:
    return np.random.default_rng([seed, index]).random((n, frames, size, size, 3),
                                                       dtype=np.float32)


def phase_extractor(device) -> dict:
    """PatchRegionExtractor at its default widths on seeded frames, in the
    serve config's compute dtype: EX_VIDEOS videos in batches of EX_BATCH;
    card vs CPU on the first batch in f32; the regions embedded by the serve
    config's model and scored by combined_sims (the f32 forward kernel,
    launch counts reset just before and read just after), and scored again
    on the card with the plain version swapped in for the kernel wrapper.
    Returns the embeddings, the kernel's launches and its max abs error."""
    from demovlp_tpu_torch import serve
    from demovlp_tpu_torch.cli import common
    from demovlp_tpu_torch.device import to_device
    from demovlp_tpu_torch.models import PatchRegionExtractor
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    cfg = json.loads(SERVE_CFG.read_text())
    obj = cfg["arch"]["args"]["object_params"]
    f, k = int(obj["num_frames"]), int(obj["object_num"])
    dtype = common.compute_dtype(cfg)
    ref = PatchRegionExtractor(object_num=k)
    ref.reset_parameters(torch.Generator().manual_seed(EX_SEED))
    ref.eval()
    size = ref.image_size[0]
    ex = PatchRegionExtractor(object_num=k, compute_dtype=dtype)
    ex.load_state_dict(ref.state_dict())
    ex = ex.to(device).eval()
    ex32 = PatchRegionExtractor(object_num=k)
    ex32.load_state_dict(ref.state_dict())
    ex32 = ex32.to(device).eval()

    first = _video_frames(EX_SEED, 0, EX_BATCH, f, size)
    with torch.inference_mode():
        got = {key: v.cpu() for key, v in ex32(to_device(first, device)).items()}
        t0 = time.perf_counter()
        want = ref(torch.from_numpy(first))
        cpu_s = time.perf_counter() - t0
    err_obj, gaps = _match_regions(got, want, ref.grid)
    err_conf = float((got["conf"] - want["conf"]).abs().max())
    slots, swaps = got["conf"].numel(), len(gaps)
    tie_gap = max(gaps, default=0.0)
    log(f"[extractor] card vs CPU, f32, {EX_BATCH} videos x {f} frames ({cpu_s:.1f} s on the "
        f"CPU): object max |err| / max |CPU| over the patches both selected {err_obj:.3e}, conf "
        f"max |err| {err_conf:.3e} slot for slot; {slots - swaps} of {slots} slots hold the same "
        f"patch, {swaps} near-tie swaps (limit {EX_MAX_SWAP_SHARE * slots:g}) across confidence "
        f"gaps {[float(f'{g:.3e}') for g in sorted(gaps, reverse=True)[:20]]}")
    if err_obj > EX_TOL_OBJECT or err_conf > EX_TOL_CONF or tie_gap > EX_TOL_CONF or \
            swaps > EX_MAX_SWAP_SHARE * slots:
        fail(f"extractor card vs CPU: object {err_obj} (limit {EX_TOL_OBJECT}), conf {err_conf} "
             f"(limit {EX_TOL_CONF}), a swap across a confidence gap of {tie_gap} "
             f"(limit {EX_TOL_CONF}), {swaps} swaps (limit {EX_MAX_SWAP_SHARE * slots:g})")
    del ex32, ref

    loader = common.init_dataloaders(cfg, val_split="test", train=False)[1][0]
    texts = [loader.dataset[i]["text"] for i in range(EX_VIDEOS)]
    batches, ms = [], []
    for i in range(EX_VIDEOS // EX_BATCH):
        frames = to_device(_video_frames(EX_SEED, i, EX_BATCH, f, size), device)
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.inference_mode():
            start.record()
            out = ex(frames)
            stop.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(stop))
        lo = i * EX_BATCH
        batches.append({"text": texts[lo:lo + EX_BATCH],
                        "object": out["object"].cpu().numpy(),
                        "object_mask": out["object_mask"].cpu().numpy(),
                        "meta": [{"paths": f"extractor://{lo + j}", "raw_captions": t}
                                 for j, t in enumerate(texts[lo:lo + EX_BATCH])]})
        if out["object"].shape != (EX_BATCH, f, k, 2054) or \
                not bool(torch.isfinite(out["object"]).all()):
            fail(f"extractor batch {i}: shape {tuple(out['object'].shape)} or non-finite values")
    steady = ms[1:] or ms
    log(f"[extractor] {EX_VIDEOS} videos x {f} frames of {size} x {size} ({dtype}, 384 x 6 "
        f"layers x 6 heads, patch 16, k = {k}): ms a batch of {EX_BATCH} {[round(x, 3) for x in ms]}; "
        f"{EX_BATCH * f * 1e3 / np.mean(steady):.1f} frames/s over batches 2-{len(ms)}")

    class Batches(list):
        batch_size = EX_BATCH

    model = common.build_serving_model(cfg, device, None, seed=0)
    cat, _ = serve.embed_loader(serve.make_embed_step(model), Batches(batches),
                                common.build_tokenizer_from_config(cfg), device,
                                transfer_dtype=dtype if dtype == torch.bfloat16 else None)
    del model
    xk.reset_launch_counts()
    t0 = time.perf_counter()
    sims = serve.combined_sims(cat, device, **common.local_score_args(cfg))
    torch.cuda.synchronize()
    sims_s = time.perf_counter() - t0
    launches = dict(xk.LAUNCHES)
    log(f"[extractor] embedded by the serve config's model and scored: {sims.shape} sims in "
        f"{sims_s:.3f} s; kernel launches {launches}")
    if sims.shape != (EX_VIDEOS, EX_VIDEOS) or not np.isfinite(sims).all():
        fail(f"extractor sims: shape {sims.shape} or non-finite")
    if launches[xk.KERNEL] != 2:
        fail(f"the extractor's sims launched the f32 forward {launches[xk.KERNEL]} times "
             "(expected 2: one a direction)")
    score = common.local_score_args(cfg)
    saved = xk.direction_sim
    xk.direction_sim = xk.direction_sim_plain
    try:
        xk.reset_launch_counts()
        plain = serve.combined_sims(cat, device, **score)
        plain_launches = dict(xk.LAUNCHES)
    finally:
        xk.direction_sim = saved
    if any(plain_launches.values()):
        fail(f"the plain extractor sims launched kernels: {plain_launches}")
    err = check_close(f"extractor sims {EX_VIDEOS}x{EX_VIDEOS}, kernel vs plain on the card",
                      torch.from_numpy(sims), torch.from_numpy(plain), score["focal_type"])
    return dict(cat=cat, launches=launches[xk.KERNEL], err=err)


def phase_timing(cat, device, tag: str = "serve"):
    """Kernel and plain version on the main path's own local-sims inputs
    (`tag`: serve, one serve's 1000 x 1000 local sims; query, one query
    call's queries against the 1000-video gallery; or extractor, the
    extractor's 64 videos against their 64 captions)."""
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
        peak, peak_text = _mode_peak(False)
        bound_ms, total["bound_by"] = _bound(flops, nbytes, peak)
        err = check_close(f"{bc}x{bq} {direction} equal ({tag} inputs)", got, want, "equal")
        log(f"[timing] {tag} {direction} {bc}x{bq} Ls={ls} Lq={lq} D={d}: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms by {total['bound_by']} "
            f"({flops:.3e} flop at {peak_text}: {1e3 * flops / PEAK_F32_FLOPS:.3f} ms; "
            f"{nbytes:.3e} B at {PEAK_BYTES:.2e} B/s: {1e3 * nbytes / PEAK_BYTES:.3f} ms), "
            f"{flops / ms / 1e9:.2f} TFLOP/s achieved")
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        total["bound_ms"] += bound_ms
        total["err"] = max(total["err"], err)
    prev = f" (previous design {PREV_MS['xattn_sim_fwd serve']} ms)" if tag == "serve" else ""
    log(f"[timing] xattn_sim_fwd, one {tag}'s local sims (both directions): kernel "
        f"{total['ms']:.3f} ms{prev}, plain {total['plain_ms']:.3f} ms, bound "
        f"{total['bound_ms']:.3f} ms")
    names = _kernel_names(lambda: xk.direction_sim(l_o[:64], l_t[:64], o_m[:64], 20.0, True))
    log(f"[timing] xattn_sim_fwd f32, profiler: device kernels {names}")
    if not any("xattn_sim_fwd_tf32_kernel" in n for n in names):
        fail(f"the profiler did not see xattn_sim_fwd_tf32_kernel run: {names}")
    return total


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _dist_entry(fn, rank: int, world: int, port: int, backend: str, out: str, args) -> None:
    """A spawned rank: torchrun's environment (every rank on card 0), the
    process group joined with `backend`, fn's result saved for the parent."""
    import traceback

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch.distributed as dist

    try:
        from demovlp_tpu_torch.parallel.mesh import setup_distributed

        setup_distributed(backend)
        torch.save(fn(rank, *args), os.path.join(out, f"rank{rank}.pt"))
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _dist_spawn(tag: str, fn, world: int, backend: str, tmp: Path, *args) -> list:
    """fn(rank, *args) on `world` spawned ranks; their results in rank
    order. Fails the phase when a rank fails or outlives DIST_TIMEOUT."""
    import multiprocessing as mp

    out = tmp / f"dist_{tag}"
    out.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_dist_entry, args=(fn, r, world, port, backend, str(out), args))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = t0 + DIST_TIMEOUT
    for r, p in enumerate(procs):
        p.join(max(1.0, deadline - time.perf_counter()))
    bad = []
    for r, p in enumerate(procs):
        if p.is_alive():
            p.kill()
            p.join(30)
            bad.append(f"rank {r} still running after {DIST_TIMEOUT} s")
        elif p.exitcode != 0:
            bad.append(f"rank {r} exited {p.exitcode}")
    if bad:
        fail(f"[dist] {tag}: " + "; ".join(bad))
    log(f"[dist] {tag}: {world} {backend} rank(s) in {time.perf_counter() - t0:.1f}s")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _dist_nccl(rank: int, cfg_path: str, port: int) -> dict:
    """NCCL at world size 1: the train CLI under torchrun's environment
    (setup_distributed joins no group at one process, so the path is the
    one-process path), then a world-1 NCCL group through which the layer's
    collectives run: the (1, 1) mesh, the differentiable row gather and the
    gradient sum."""
    import torch.distributed as dist

    from demovlp_tpu_torch.cli.train import run
    from demovlp_tpu_torch.parallel.mesh import create_mesh, gather_rows, reduce_gradients

    trainer = run(["-c", cfg_path])
    res = {"losses": list(trainer.step_losses), "group_after_cli": dist.is_initialized(),
           "mesh_after_cli": trainer.mesh is not None}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    mesh = create_mesh(1, "cuda")
    x = torch.randn(4, 3, device="cuda", requires_grad=True)
    y = gather_rows(x, dist.group.WORLD)
    y.sum().backward()
    lin = torch.nn.Linear(3, 2).cuda()
    lin(x.detach()).sum().backward()
    g = lin.weight.grad.clone()
    reduce_gradients(lin.parameters(), dist.group.WORLD)
    torch.cuda.synchronize()
    res.update(mesh=str(mesh), backend=dist.get_backend(), gather=bool(torch.equal(y, x)),
               gather_grad=bool(torch.equal(x.grad, torch.ones_like(x))),
               reduce=bool(torch.equal(g, lin.weight.grad)))
    return res


def _dist_batches(cfg: dict, index: int, count: int) -> list:
    """The first DIST_STEPS epoch-1 train batches (host arrays) of loader
    shard `index` of `count`."""
    from demovlp_tpu_torch.cli import common
    from demovlp_tpu_torch.data.loader import MultiDistTextObjectVideoDataLoader
    from demovlp_tpu_torch.train.steps import prepare_batch

    dl = MultiDistTextObjectVideoDataLoader(**{**cfg["data_loader"]["args"],
                                               "process_index": index, "process_count": count})
    dl.set_epoch(1)
    tok = common.build_tokenizer_from_config(cfg)
    return [prepare_batch(data, tok) for _, data in zip(range(DIST_STEPS), dl)]


def _dist_steps(cfg: dict, device, mesh, batches, grads: bool = False) -> dict:
    """DIST_STEPS deterministic train steps from the seeded init on `batches`:
    losses, the kernels' launches, the parameters after the last step. With
    `grads`, also step 1's gradients on the host: as the optimizer read them
    ("grads") and as backward left them, before any sum over ranks ("pre")."""
    from demovlp_tpu_torch.cli import common
    from demovlp_tpu_torch.ops import xattn_kernel as xk
    from demovlp_tpu_torch.train.steps import batch_to_device, make_retrieval_train_step

    model = common.build_train_model(cfg, device, seed=0, mesh=mesh)
    opt = common.build_optimizer(cfg, model.parameters())
    step = make_retrieval_train_step(model, common.build_loss(cfg), opt, deterministic=True,
                                     mesh=mesh)
    transfer = torch.bfloat16 if common.compute_dtype(cfg) == torch.bfloat16 else None
    lr = float(cfg["optimizer"]["args"]["lr"])
    pre, hooks = {}, []
    if grads:
        hooks = [p.register_post_accumulate_grad_hook(
            lambda p, n=n: pre.__setitem__(n, p.grad.detach().clone()))
            for n, p in model.named_parameters() if p.requires_grad]
    torch.cuda.synchronize()
    xk.reset_launch_counts()
    losses, times, after = [], [], None
    for arrays in batches:
        t0 = time.perf_counter()
        m = step(batch_to_device(arrays, device, transfer), lr)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
        if hooks:
            for h in hooks:
                h.remove()
            hooks = []
            after = {n: p.grad.float().cpu() for n, p in model.named_parameters()
                     if p.grad is not None}
            pre = {n: g.float().cpu() for n, g in pre.items()}
    return {"model": model, "losses": losses, "launches": dict(xk.LAUNCHES), "times": times,
            "lr": lr, "grads": after, "pre": pre}


def _exact_zero_grad(name: str, w: torch.Tensor) -> torch.Tensor:
    """The elements whose gradient is zero in exact arithmetic: an attention
    key bias adds q . b_k to every score of a query's row, which the row's
    softmax cancels (DistilBERT's k_lin.bias, the k third of a fused qkv
    bias). What the runs hold there is rounding, of no scale of its own."""
    mask = torch.zeros_like(w, dtype=torch.bool)
    if name.endswith("k_lin.bias"):
        mask[:] = True
    elif name.endswith("qkv.bias"):
        d = w.shape[0] // 3
        mask[d:2 * d] = True
    return mask


def _grads_against(got: dict, want: dict) -> dict:
    """Each of want's tensors against got's, over the elements whose exact
    gradient is not zero (a gradient missing from `got` counts as zeros):
    "norm", the three worst by |got - want| / |want| (2-norms) as (ratio,
    name); "max", the worst by max |got - want| / max |want|."""
    def ratio(num: float, den: float) -> float:
        return num / den if den > 0 else (0.0 if num == 0 else float("inf"))

    rows, worst_max = [], (0.0, "")
    for name, w in want.items():
        keep = ~_exact_zero_grad(name, w)
        if not keep.any():
            continue
        g = got[name][keep] if name in got else torch.zeros_like(w[keep])
        w = w[keep].double()
        d = g.double() - w
        rows.append((ratio(float(d.norm()), float(w.norm())), name))
        worst_max = max(worst_max, (ratio(float(d.abs().max()), float(w.abs().max())), name))
    return {"norm": sorted(rows, reverse=True)[:3], "max": worst_max}


def _zero_grad_max(grads: dict) -> tuple:
    """(largest |gradient| on the exact-zero elements, largest anywhere)."""
    zero = max((float(g[_exact_zero_grad(n, g)].abs().max()) for n, g in grads.items()
                if _exact_zero_grad(n, g).any()), default=0.0)
    return zero, max(float(g.abs().max()) for g in grads.values())


def _params_against(got, want, lr: float, steps: int) -> dict:
    """Parameter differences: the largest (at most 2 lr + slack anywhere),
    the mean over every element in units of lr, the share beyond the
    tight tolerance."""
    tol = TRAIN_REF_PARAM
    worst, total_abs, loose, total = 0.0, 0.0, 0, 0
    for name, w in want.items():
        v = got[name].float().cpu()
        w = w.float().cpu()
        err = (v - w).abs()
        worst = max(worst, float(err.max()))
        total_abs += float(err.double().sum())
        loose += int((err > tol["atol"] + tol["rtol"] * w.abs()).sum())
        total += err.numel()
    return {"worst": worst, "mean_over_lr": total_abs / total / lr,
            "loose_share": loose / total,
            "bound": 2 * ADAM_STEP_MAX * lr * steps + tol["atol"]}


def _dist_train(rank: int, cfg: dict, model_axis: int, steps: int) -> dict:
    """`steps` deterministic train steps on this rank's loader shard over a
    (data, model_axis) mesh: data parallel, tensor parallel, or both. Rank
    0 then runs the one-process steps on the concatenated global batches
    (every data rank's shard in rank order) and compares, the TP weights
    gathered whole."""
    from demovlp_tpu_torch.parallel.mesh import (create_mesh, data_coords, host_allgather,
                                                 local_rank)
    from demovlp_tpu_torch.parallel.tp import full_state_dict

    device = torch.device("cuda", local_rank())
    mesh = create_mesh(model_axis, "cuda")
    d, n = data_coords(mesh)
    compare = rank == 0 and model_axis == 1  # data parallel: hold the gradients too
    run = _dist_steps(cfg, device, mesh, _dist_batches(cfg, d, n)[:steps], grads=compare)
    split = sum(hasattr(p, "placements") for p in run["model"].parameters())
    params = full_state_dict(run["model"])
    sums = host_allgather(np.asarray([[float(v.double().sum()) for v in params.values()]]))
    res = {"losses": run["losses"], "launches": run["launches"], "times": run["times"],
           "split": split, "ranks_equal": bool((sums == sums[:1]).all())}
    if rank == 0:
        grads, pre = run["grads"], run["pre"]
        del run
        torch.cuda.empty_cache()
        shards = [_dist_batches(cfg, r, n)[:steps] for r in range(n)]
        glob = [{k: np.concatenate([s[i][k] for s in shards]) for k in shards[0][i]}
                for i in range(steps)]
        one = _dist_steps({**cfg, "mesh": {"model": 1}}, device, None, glob, grads=compare)
        want = {name: p.detach() for name, p in one["model"].named_parameters()}
        res.update(ref_losses=one["losses"], ref_launches=one["launches"],
                   ref_times=one["times"],
                   params=_params_against({k: params[k] for k in want}, want, one["lr"],
                                          steps))
        if compare:
            res.update(grads=_grads_against(grads, one["grads"]),
                       fault=_grads_against(pre, one["grads"]),
                       zero=(_zero_grad_max(grads), _zero_grad_max(one["grads"])))
    return res


def _dist_eval(rank: int, out: str) -> dict:
    """The 1000-video gallery of the serve config over the ranks: each
    embeds its loader shard and scores its block of gallery rows through
    the f32 forward; rank 0 keeps the gathered embeddings for the parent."""
    from demovlp_tpu_torch import serve
    from demovlp_tpu_torch.cli import common
    from demovlp_tpu_torch.ops import xattn_kernel as xk
    from demovlp_tpu_torch.parallel.mesh import create_mesh, local_rank

    cfg = json.loads(SERVE_CFG.read_text())
    device = torch.device("cuda", local_rank())
    mesh = create_mesh(1, "cuda")
    model = common.build_serving_model(cfg, device, None, 0, mesh=mesh)
    dl = common.init_dataloaders(cfg, val_split="test", train=False, mesh=mesh)[1][0]
    t0 = time.perf_counter()
    cat, meta = serve.embed_loader(serve.make_embed_step(model), dl,
                                   common.build_tokenizer_from_config(cfg), device,
                                   transfer_dtype=torch.bfloat16, mesh=mesh)
    embed_s = time.perf_counter() - t0
    xk.reset_launch_counts()
    t0 = time.perf_counter()
    sims = serve.combined_sims(cat, device, mesh=mesh, **common.local_score_args(cfg))
    sims_s = time.perf_counter() - t0
    if rank == 0:
        np.savez(os.path.join(out, "dist_cat.npz"), **cat)
    return {"sims": sims, "launches": dict(xk.LAUNCHES), "embed_s": embed_s, "sims_s": sims_s,
            "n_local": len(dl) * dl.batch_size, "paths": meta["paths"]}


def _tp_config(rows: int) -> dict:
    """ab_local_bf16.json's widths at depth DIST_TP_DEPTH in f32, mesh.model
    2, `rows` rows a data rank (DIST_TP_ROWS over the data ranks)."""
    cfg = json.loads(TRAIN_CFG.read_text())
    args = cfg["arch"]["args"]
    args["object_params"]["depth"] = DIST_TP_DEPTH
    args["text_params"]["config"] = {"n_layers": DIST_TP_DEPTH}
    cfg["precision"]["compute"] = "float32"
    cfg["loss"]["args"]["local_dtype"] = "float32"
    cfg["mesh"]["model"] = 2
    cfg["data_loader"]["args"]["batch_size"] = rows
    return cfg


def check_dist_dp(ranks: list, where: str) -> None:
    """Data-parallel steps (ranks[0] carries the one-process comparison):
    every rank's and the one-process run's kernels launched each step,
    losses within DIST_LOSS_RTOL, parameters as DIST_PARAM_MEAN says, the
    ranks' weights identical."""
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    r0, n = ranks[0], len(ranks)
    steps = len(r0["losses"])
    for r, res in enumerate(ranks):
        log(f"[dist] dp rank {r}: losses {res['losses']}, step s "
            f"{[round(t, 3) for t in res['times']]} ({where}), launches {res['launches']}")
    p = r0["params"]
    log(f"[dist] dp one process, the {n} ranks' rows together: losses {r0['ref_losses']}, "
        f"step s {[round(t, 3) for t in r0['ref_times']]}, launches {r0['ref_launches']}")
    (g_err, g_at), (f_err, f_at) = r0["grads"]["norm"][0], r0["fault"]["norm"][0]
    top = ", ".join(f"{e:.3e} at {n}" for e, n in r0["grads"]["norm"])
    log(f"[dist] dp vs one process, step-1 gradients summed over the ranks: |diff| / |value| "
        f"per tensor, the worst: {top} (limit {DIST_GRAD_TOL:g}); by max |diff| / max |value| "
        f"{r0['grads']['max'][0]:.3e} at {r0['grads']['max'][1]}; planted fault, rank 0's "
        f"gradient before the sum: {f_err:.3e} at {f_at} (must exceed the limit), by max "
        f"{r0['fault']['max'][0]:.3e}")
    (dz, dg), (oz, og) = r0["zero"]
    log(f"[dist] dp: the attention key biases' gradients (zero in exact arithmetic, left "
        f"out above) reach {dz:.3e} summed over the ranks and {oz:.3e} in one process, "
        f"against {dg:.3e} / {og:.3e} at the largest anywhere")
    log(f"[dist] dp vs one process after {steps} steps: parameters max |diff| "
        f"{p['worst']:.3e}, mean |diff| {p['mean_over_lr']:.4f} lr (limit {DIST_PARAM_MEAN} "
        f"lr), share beyond {TRAIN_REF_PARAM['atol']:g} + {TRAIN_REF_PARAM['rtol']:g}|p| "
        f"{p['loose_share']:.3e}; ranks identical {r0['ranks_equal']}")
    kernels = (xk.KERNEL_BF16, xk.KERNEL_DQ, xk.KERNEL_DC)
    for launches, what in [(res["launches"], f"rank {r}") for r, res in enumerate(ranks)] + [
            (r0["ref_launches"], "one process")]:
        if any(launches[k] < steps for k in kernels):
            fail(f"[dist] dp {what} did not launch the bf16 forward and both backward "
                 f"kernels each step: {launches}")
    for res in ranks:
        for got, want in zip(res["losses"], r0["ref_losses"]):
            if not np.isfinite(got) or abs(got - want) > DIST_LOSS_RTOL * abs(want):
                fail(f"[dist] dp loss {got} vs one process {want}")
    if not g_err <= DIST_GRAD_TOL:
        fail(f"[dist] dp step-1 gradients disagree with the one-process step: {g_err} at {g_at}")
    if not f_err > DIST_GRAD_TOL:
        fail(f"[dist] dp gradient check blind: the unsummed gradient reads {f_err} at {f_at}")
    if not r0["ranks_equal"] or p["mean_over_lr"] > DIST_PARAM_MEAN:
        fail(f"[dist] dp parameters disagree with the one-process steps: {p}")


def check_dist_tp(ranks: list, where: str) -> None:
    """Tensor-parallel steps (ranks[0] carries the one-rank comparison):
    something split on every rank, the f32 kernels launched, losses and
    parameters within TRAIN_REF's f32 limits, the ranks' weights identical."""
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    r0 = ranks[0]
    p = r0["params"]
    for r, res in enumerate(ranks):
        log(f"[dist] tp rank {r}: loss {res['losses']}, step s "
            f"{[round(t, 3) for t in res['times']]} ({where}), {res['split']} parameter "
            f"tensors split, launches {res['launches']}")
        for got, want in zip(res["losses"], r0["ref_losses"]):
            if not np.isfinite(got) or abs(got - want) > TRAIN_REF_LOSS_RTOL * abs(want) + 1e-6:
                fail(f"[dist] tp loss {got} vs one rank {want}")
        if res["split"] == 0 or min(res["launches"][k] for k in (xk.KERNEL, xk.KERNEL_DQ,
                                                                 xk.KERNEL_DC)) < 1:
            fail(f"[dist] tp rank {r}: nothing split or a kernel not launched: {res}")
    log(f"[dist] tp vs one rank (depth {DIST_TP_DEPTH}, f32, {DIST_TP_ROWS} rows): loss "
        f"{r0['ref_losses']}; "
        f"parameters max |diff| {p['worst']:.3e} (limit {p['bound']:.3e}), share beyond "
        f"{TRAIN_REF_PARAM['atol']:g} + {TRAIN_REF_PARAM['rtol']:g}|p| {p['loose_share']:.3e} "
        f"(limit {TRAIN_REF_PARAM['max_loose_share']:g}); ranks identical {r0['ranks_equal']}")
    if (not r0["ranks_equal"] or p["worst"] > p["bound"]
            or p["loose_share"] > TRAIN_REF_PARAM["max_loose_share"]):
        fail(f"[dist] tp parameters disagree with the one-rank step: {p}")


def check_dist_eval(ranks: list, dcat: dict, device, where: str) -> None:
    """The sharded eval: each rank's gathered sims (where it returned them)
    against one-process scoring of the gathered embeddings `dcat` on this
    card, within TOL_SMOOTH and with identical top-10."""
    from demovlp_tpu_torch import serve
    from demovlp_tpu_torch.cli import common
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    score = common.local_score_args(json.loads(SERVE_CFG.read_text()))
    xk.reset_launch_counts()
    want = serve.combined_sims(dcat, device, **score)
    log(f"[dist] eval one-process scoring of the gathered embeddings: launches "
        f"{dict(xk.LAUNCHES)}")
    top = np.argsort(-want, axis=1)[:, :10]
    for r, res in enumerate(ranks):
        log(f"[dist] eval rank {r}: {res['n_local']} rows embedded in {res['embed_s']:.2f}s, "
            f"sims in {res['sims_s']:.2f}s ({where}); launches {res['launches']}")
        if res["launches"][xk.KERNEL] < 1:
            fail(f"[dist] eval rank {r} launched no f32 forward")
        if res.get("sims") is None:
            continue
        err = float(np.abs(res["sims"] - want).max())
        same_top = bool(np.array_equal(np.argsort(-res["sims"], axis=1)[:, :10], top))
        log(f"[dist] eval rank {r}: sims vs one process max |diff| {err:.3e} (limit "
            f"{TOL_SMOOTH:g}), top-10 identical {same_top}")
        if err > TOL_SMOOTH or not same_top or res["sims"].shape != want.shape:
            fail(f"[dist] eval rank {r}: sims disagree with one process ({err}, top-10 "
                 f"{same_top})")


def dist_train_config(rows: int) -> dict:
    """ab_local_bf16.json at `rows` rows a data rank."""
    cfg = json.loads(TRAIN_CFG.read_text())
    cfg["data_loader"]["args"]["batch_size"] = rows
    return cfg


def phase_kernels_block(device, segment: int, n: int) -> dict:
    """The blocked local loss's shapes: `segment` image items against n
    captions (i2t) and n captions against `segment` images (t2i), D = 256,
    (Ls, Lq) = (30, 99) / (99, 30), bf16 mode, both focal types. Each
    kernel run twice and held bit-identical. The bf16 forward against its
    plain version (TOL_TRAIN's bf16 limit with the flip allowance) and
    equal, bit for bit, to the same pairs' sims in the n x n call. The
    backward pair against the n x n call with the cotangent zero outside
    the block (the same pairs' shares at another S: within BLOCK_BWD_ORDER
    of the largest entry), and against its plain version at TOL_TRAIN's
    bf16 limit with the flip allowance, scaled by block_flip_scale where an
    entry sums over the block's `segment` partners (i2t d_query, t2i
    d_context). The worst max abs error of each kernel."""
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    reg, rmask = _train_inputs(70, n, 30, 256, device)
    wrd, wmask = _train_inputs(71, n, 99, 256, device)
    r, w = xk.round_bf16(reg), xk.round_bf16(wrd)
    rb, rbm = r[:segment].contiguous(), rmask[:segment].contiguous()
    worst = {xk.KERNEL_BF16: 0.0, xk.KERNEL_DQ: 0.0, xk.KERNEL_DC: 0.0}
    tol, flip = TOL_TRAIN["bf16"], (TOL_TRAIN_FLIP, MAX_TRAIN_FLIP_SHARE)
    block_flip = (TOL_TRAIN_FLIP * block_flip_scale(n, segment), MAX_TRAIN_FLIP_SHARE)
    for focal in ("prob", "equal"):
        eq = focal == "equal"
        for direction, args, whole_args in (("i2t", (rb, w, rbm), (r, w, rmask)),
                                            ("t2i", (w, rb, wmask), (w, r, wmask))):
            ctx, qry, cm = args
            blk = (slice(0, segment), slice(None)) if direction == "i2t" else (
                slice(None), slice(0, segment))
            tag = f"block {ctx.shape[0]}x{qry.shape[0]} Ls={ctx.shape[1]} {direction} {focal} bf16"
            got = xk.direction_sim(ctx, qry, cm, 20.0, eq, True)
            if not torch.equal(got, xk.direction_sim(ctx, qry, cm, 20.0, eq, True)):
                fail(f"{tag}: two bf16 forward runs differ (must be bit-identical)")
            whole = xk.direction_sim(*whole_args, 20.0, eq, True)[blk]
            if not torch.equal(got, whole):
                fail(f"{tag}: the block's sims differ from the same pairs' sims in the "
                     f"{n}x{n} call by up to {float((got - whole).abs().max())}")
            worst[xk.KERNEL_BF16] = max(worst[xk.KERNEL_BF16], check_rel(
                f"{tag} forward", got, xk.direction_sim_plain(ctx, qry, cm, 20.0, eq, True),
                tol, *flip))
            g = torch.randn(ctx.shape[0], qry.shape[0],
                            generator=torch.Generator().manual_seed(72)).to(device)
            bargs = (ctx, qry, cm, g, 20.0, eq, True)
            dc, dq = xk.direction_sim_bwd(*bargs)
            dc2, dq2 = xk.direction_sim_bwd(*bargs)
            if not (torch.equal(dc, dc2) and torch.equal(dq, dq2)):
                fail(f"{tag}: two backward runs differ (must be bit-identical)")
            g_whole = torch.zeros(n, n, device=device)
            g_whole[blk] = g
            wdc, wdq = xk.direction_sim_bwd(*whole_args, g_whole, 20.0, eq, True)
            wdc, wdq = (wdc[:segment], wdq) if direction == "i2t" else (wdc, wdq[:segment])
            for name, x, y in (("d_context", dc, wdc), ("d_query", dq, wdq)):
                rel = float((x - y).abs().max()) / (float(y.abs().max()) or 1.0)
                log(f"[resume] {tag} {name}: against the {n}x{n} call with g zero outside the "
                    f"block, max |diff| / max |value| {rel:.3e} (limit {BLOCK_BWD_ORDER:g})")
                if rel > BLOCK_BWD_ORDER:
                    fail(f"{tag} {name}: the block's backward differs from the whole call's "
                         f"by {rel} of its largest entry")
            pdc, pdq = xk.direction_sim_bwd_plain(*bargs)
            log(f"[resume] {tag}: (S, slots) d_query {xk.backward_plan(xk.KERNEL_DQ, ctx, qry, True)}"
                f", d_context {xk.backward_plan(xk.KERNEL_DC, ctx, qry, True)}, forward S "
                f"{xk.bf16_forward_splits(ctx.shape[0], qry.shape[0], ctx.shape[1], qry.shape[1], 256)}")
            # which output sums over the block's `segment` partners
            dc_flip, dq_flip = (flip, block_flip) if direction == "i2t" else (block_flip, flip)
            worst[xk.KERNEL_DC] = max(worst[xk.KERNEL_DC], check_backward(
                f"{tag} d_context", dc, pdc, tol, dc_flip, None))
            worst[xk.KERNEL_DQ] = max(worst[xk.KERNEL_DQ], check_backward(
                f"{tag} d_query", dq, pdq, tol, dq_flip, None))
    log(f"[resume] block shapes {segment}x{n} / {n}x{segment}: every kernel within its "
        "limits, bit-identical on rerun, the block's results those of the whole call")
    return worst


def _resume_config(tmp: Path, tag: str, **trainer) -> Path:
    """[resume]'s config file (RESUME_SEGMENT's comment) under tmp/<tag>."""
    cfg = json.loads(TRAIN_CFG.read_text())
    cfg["name"] = f"Resume_{tag}"
    cfg["precision"]["norm"] = "bfloat16"
    cfg["loss"]["args"]["local_block_segment"] = RESUME_SEGMENT
    cfg["data_loader"]["args"]["object_params"]["num_samples"] = RESUME_SAMPLES
    cfg["trainer"].update(epochs=2, max_samples_per_epoch=RESUME_SAMPLES, init_val=False,
                          resume="auto", monitor="min val_loss_0", save_dir=str(tmp / tag),
                          **trainer)
    path = tmp / f"{tag}.json"
    path.write_text(json.dumps(cfg))
    return path


def _run_dir(cfg_path: Path, stamp: str) -> Path:
    cfg = json.loads(cfg_path.read_text())
    return Path(cfg["trainer"]["save_dir"]) / "models" / cfg["name"] / stamp


def _step_launches(fn) -> dict:
    """{kernel name: launches} of one call of fn, from the profiler (device
    kernels only: no copies or fills); empty where the session recorded no
    device kernel, which the caller reports as not measured."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and not e.key.startswith(("Memcpy", "Memset"))}


def _resume_steps(tmp: Path, device) -> dict:
    """One full-width step of [resume]'s config three ways from the same
    weights, batch and dropout key: blocked (bf16 norms), unblocked (bf16
    norms) and blocked with f32 norms. Blocked against unblocked: the loss
    bit for bit and the gradients within RESUME_BLOCK_GRAD_TOL. Each: the
    first step's loss, the median of 5 more fenced steps, and the kernel
    launches of one more step from the profiler."""
    import copy

    from demovlp_tpu_torch.cli import common
    from demovlp_tpu_torch.train.steps import (batch_to_device, make_retrieval_train_step,
                                               prepare_batch)

    base = json.loads(_resume_config(tmp, "steps").read_text())
    dl = common.init_dataloaders(base)[0][0]
    dl.set_epoch(1)
    data = next(iter(dl))
    batch = batch_to_device(prepare_batch(data, common.build_tokenizer_from_config(base)),
                            device, torch.bfloat16)
    lr = float(base["optimizer"]["args"]["lr"])
    res = {}
    for tag, norm, segment in (("blocked", "bfloat16", RESUME_SEGMENT),
                               ("unblocked", "bfloat16", 0),
                               ("f32 norms", "float32", RESUME_SEGMENT)):
        cfg = copy.deepcopy(base)
        cfg["precision"]["norm"] = norm
        cfg["loss"]["args"]["local_block_segment"] = segment
        model = common.build_train_model(cfg, device, seed=0)
        step = make_retrieval_train_step(model, common.build_loss(cfg),
                                         common.build_optimizer(cfg, model.parameters()))
        loss = float(step(batch, lr)["loss"])
        grads = {n: p.grad.detach().float().clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(batch, lr)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        launches = _step_launches(lambda: step(batch, lr))
        res[tag] = dict(loss=loss, grads=grads if tag != "f32 norms" else None,
                        ms=float(np.median(times)), times=times, launches=launches)
        del model, step, grads
        torch.cuda.empty_cache()
    a, b = res["blocked"], res["unblocked"]
    log(f"[resume] one full-width step (f=1, k=30, batch 128, bf16 towers and local loss, "
        f"bf16 norms): loss blocked ({RESUME_SEGMENT} rows a block) {a['loss']!r}, unblocked "
        f"{b['loss']!r} (bit-identical: {a['loss'] == b['loss']})")
    if not np.isfinite(a["loss"]) or a["loss"] != b["loss"]:
        fail(f"[resume] blocked loss {a['loss']!r} != unblocked {b['loss']!r}")
    worst, at, same = 0.0, "", 0
    for name, g in b["grads"].items():
        keep = ~_exact_zero_grad(name, g)  # rounding only there, of no scale
        got = a["grads"][name]
        d = float((got[keep] - g[keep]).norm()) / (float(g[keep].norm()) or 1.0)
        same += int(torch.equal(got, g))
        if d > worst:
            worst, at = d, name
        if not bool(torch.isfinite(got).all()) or d > RESUME_BLOCK_GRAD_TOL:
            fail(f"[resume] blocked gradient {name}: |diff| / |g| {d} (limit "
                 f"{RESUME_BLOCK_GRAD_TOL:g})")
    log(f"[resume] step-1 gradients blocked vs unblocked, {len(b['grads'])} tensors: {same} "
        f"bit-identical, worst |diff| / |g| {worst:.3e} at {at} (limit {RESUME_BLOCK_GRAD_TOL:g}; "
        "the attention key biases, whose exact gradient is zero, left out)")
    f32, bf = res["f32 norms"], res["blocked"]
    n32, nbf, nub = (sum(r["launches"].values()) or "not measured (an empty profiler session)"
                     for r in (f32, bf, b))
    log(f"[resume] norms f32 vs bf16 (blocked): step-1 loss {f32['loss']!r} vs {bf['loss']!r}; "
        f"fenced step median {f32['ms']:.3f} ms vs {bf['ms']:.3f} ms (5 steps each: "
        f"{[round(t, 3) for t in f32['times']]} / {[round(t, 3) for t in bf['times']]}); "
        f"kernel launches a step (profiler) {n32} vs {nbf}; unblocked bf16 norms "
        f"{nub} launches, {b['ms']:.3f} ms")
    moved = sorted(((f32["launches"].get(k, 0) - bf["launches"].get(k, 0), k)
                    for k in set(f32["launches"]) | set(bf["launches"])),
                   key=lambda x: -abs(x[0]))
    for diff, key in moved[:8]:
        if diff:
            log(f"[resume]   launches f32 norms - bf16 norms {diff:+d}  {key[:110]}")
    if not np.isfinite(f32["loss"]):
        fail(f"[resume] non-finite loss with f32 norms: {f32['loss']}")
    return dict(launches_f32=n32, launches_bf16=nbf, launches_unblocked=nub, ms_f32=f32["ms"],
                ms_bf16=bf["ms"], ms_unblocked=b["ms"])


def _ckpt_compare(got: Path, want: Path, what: str) -> float:
    """The largest |difference| over two checkpoints' weights and AdamW
    moments; fails unless every tensor and count is equal."""
    a = torch.load(got, map_location="cpu", weights_only=True)
    b = torch.load(want, map_location="cpu", weights_only=True)
    if a["state_dict"].keys() != b["state_dict"].keys() or a["epoch"] != b["epoch"]:
        fail(f"[resume] {what}: the checkpoints hold other keys or epochs")
    worst, unequal = 0.0, []
    pairs = [(f"state_dict.{k}", v, b["state_dict"][k]) for k, v in a["state_dict"].items()]
    for i, st in a["optimizer"]["state"].items():
        if st["count"] != b["optimizer"]["state"][i]["count"]:
            unequal.append(f"optimizer.{i}.count")
        pairs += [(f"optimizer.{i}.{k}", st[k], b["optimizer"]["state"][i][k])
                  for k in ("mu", "nu")]
    for name, x, y in pairs:
        if not torch.equal(x, y):
            unequal.append(name)
            worst = max(worst, float((x.float() - y.float()).abs().max()))
    log(f"[resume] {what}: {len(pairs)} tensors, largest |difference| {worst!r}, "
        f"{len(unequal)} unequal")
    if unequal:
        fail(f"[resume] {what}: {len(unequal)} tensors differ (first {unequal[:4]}), "
             f"largest |difference| {worst}")
    return worst


def _train_cli_process(cfg: Path, stamp: str, log_path: Path) -> subprocess.Popen:
    env = dict(os.environ, DEMOVLP_RUN_ID=stamp, PYTHONPATH=str(ROOT))
    with open(log_path, "w") as out:
        return subprocess.Popen([sys.executable, "-m", "demovlp_tpu_torch.cli.train",
                                 "-c", str(cfg)], cwd=ROOT, env=env, stdout=out,
                                stderr=subprocess.STDOUT)


def _in_process_run(cfg: Path, stamp: str):
    from demovlp_tpu_torch.cli.train import run

    os.environ["DEMOVLP_RUN_ID"] = stamp
    try:
        return run(["-c", str(cfg)])
    finally:
        del os.environ["DEMOVLP_RUN_ID"]


def phase_resume(tmp: Path, device) -> dict:
    """[resume]: the blocked local loss's kernels at their block shapes, one
    step blocked against unblocked and with f32 against bf16 norms, then the
    train CLI on [resume]'s config in process with the asynchronous save
    (launch counts reset just before and read just after); then in
    subprocesses a run killed with SIGKILL once epoch 1's .pth is committed
    and the same command again with trainer.resume "auto" and the blocking
    save, whose epoch-2 file must equal the in-process run's. Each save's
    stall on the training thread, its write's time and each epoch's wall
    time are printed."""
    import signal

    from demovlp_tpu_torch.ops import xattn_kernel as xk

    batch = int(json.loads(TRAIN_CFG.read_text())["data_loader"]["args"]["batch_size"])
    errs = phase_kernels_block(device, RESUME_SEGMENT, batch)
    steps = _resume_steps(tmp, device)
    cfg = _resume_config(tmp, "async")
    torch.cuda.empty_cache()
    xk.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = _in_process_run(cfg, "async")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(xk.LAUNCHES)
    mgr = trainer.checkpoint
    n_steps = len(trainer.step_losses)
    log(f"[resume] async save: train CLI in process, {n_steps} steps of {batch} in 2 epochs, "
        f"{wall:.1f} s wall; per epoch: wall {[round(t, 3) for t in trainer.epoch_times]} s, "
        f"save() held the training thread {[round(r['stall_s'], 3) for r in mgr.saves]} s, "
        f"the write took {[round(r['write_s'], 3) for r in mgr.saves]} s on the writer thread; "
        f"losses {[round(x, 6) for x in trainer.step_losses]}; kernel launches {launches}")
    if n_steps != 2 * RESUME_SAMPLES // batch or not all(np.isfinite(trainer.step_losses)):
        fail(f"[resume] expected {2 * RESUME_SAMPLES // batch} finite losses, got "
             f"{trainer.step_losses}")
    # two directions a block, in every train step and, for the val
    # loss, every validation batch (the forward only)
    per_step = 2 * (batch // RESUME_SEGMENT)
    val_batches = 2 * sum(len(dl) for dl in trainer.valid_data_loader)
    for k, calls in ((xk.KERNEL_BF16, n_steps + val_batches), (xk.KERNEL_DQ, n_steps),
                     (xk.KERNEL_DC, n_steps)):
        if launches[k] != per_step * calls:
            fail(f"[resume] {k} launched {launches[k]} times, not {per_step} a call of the "
                 f"loss ({calls} calls) in {RESUME_SEGMENT}-row blocks")
    if launches[xk.KERNEL] < 1:
        fail("[resume] validation launched no f32 forward")
    run = dict(launches=launches, wall=wall, epochs=list(trainer.epoch_times),
               saves=[dict(r) for r in mgr.saves])
    local = _first_batch_local(trainer)
    for k in ("l_o", "o_mask"):
        local[k] = local[k][:RESUME_SEGMENT].contiguous()
    timing = phase_timing_train(local, True, True, f"resume block {RESUME_SEGMENT}x{batch}",
                                device, profile=False)
    del trainer, mgr
    gc.collect()
    a_dir = _run_dir(cfg, "async")
    torch.cuda.empty_cache()
    kill = _resume_config(tmp, "kill")
    run1, run2 = _run_dir(kill, "run1"), _run_dir(kill, "run2")
    proc = _train_cli_process(kill, "run1", tmp / "run1.log")
    t0 = time.perf_counter()
    try:
        while not (run1 / "checkpoint-epoch1.pth").exists():
            if proc.poll() is not None:
                fail(f"[resume] the run to kill exited ({proc.returncode}) first:\n"
                     + (tmp / "run1.log").read_text()[-3000:])
            if time.perf_counter() - t0 > RESUME_TIMEOUT:
                fail("[resume] epoch 1's checkpoint never appeared")
            time.sleep(0.05)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    left = sorted(p.name for p in run1.iterdir() if p.name.startswith(("checkpoint", "model")))
    log(f"[resume] killed the run with SIGKILL {time.perf_counter() - t0:.1f} s after its "
        f"start, once checkpoint-epoch1.pth was committed; its directory holds {left}")
    if (run1 / "checkpoint-epoch2.pth").exists():
        fail("[resume] the kill came after epoch 2 was committed")
    _ckpt_compare(run1 / "checkpoint-epoch1.pth", a_dir / "checkpoint-epoch1.pth",
                  "epoch 1, the killed run (subprocess) vs the in-process run")
    _resume_config(tmp, "kill", async_checkpoint=False)  # the relaunch saves blocking
    proc = _train_cli_process(kill, "run2", tmp / "run2.log")
    try:
        rc = proc.wait(timeout=RESUME_TIMEOUT)
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = (tmp / "run2.log").read_text()
    if rc != 0 or "Resumed from" not in text or "checkpoint-epoch1.pth" not in text:
        fail(f"[resume] the relaunch (exit {rc}) did not resume from epoch 1:\n{text[-3000:]}")
    if (run2 / "checkpoint-epoch1.pth").exists():
        fail("[resume] the relaunch trained epoch 1 again")
    diff = _ckpt_compare(run2 / "checkpoint-epoch2.pth", a_dir / "checkpoint-epoch2.pth",
                         "epoch 2, killed and resumed with the blocking save vs uninterrupted "
                         "with the asynchronous save")
    for line in text.splitlines():
        if "held the training thread" in line or "written in" in line:
            log(f"[resume] relaunch (blocking save): {line.strip()}")
    return dict(errs=errs, timing=timing, launches=launches, steps=steps, run=run,
                resume_diff=diff)


def phase_dist(tmp: Path, device, cat) -> None:
    """[dist]: (a) NCCL at world size 1; (b) two gloo ranks on the one card:
    data-parallel train steps at full width, the sharded eval of the
    1000-video gallery, one tensor-parallel step. Times are of two
    processes sharing one card and claim nothing about speed."""
    torch.cuda.empty_cache()
    smoke = json.loads(SMOKE_CFG.read_text())
    smoke["trainer"].update(epochs=1, save_dir=str(tmp / "dist_nccl"))
    smoke_path = tmp / "dist_smoke.json"
    smoke_path.write_text(json.dumps(smoke))
    (a,) = _dist_spawn("nccl", _dist_nccl, 1, "nccl", tmp, str(smoke_path), _free_port())
    log(f"[dist] nccl world size 1: train CLI under torchrun's environment, {len(a['losses'])} "
        f"steps, losses {[round(v, 5) for v in a['losses']]}, a process group after it: "
        f"{a['group_after_cli']}; then {a['backend']} {a['mesh']}: row gather {a['gather']} "
        f"(its gradient {a['gather_grad']}), gradient sum {a['reduce']}")
    if a["group_after_cli"] or a["mesh_after_cli"] or not a["losses"]:
        fail("[dist] the one-process train CLI under torchrun's environment made a group or "
             "a mesh, or took no step")
    if not np.isfinite(a["losses"]).all() or not (a["gather"] and a["gather_grad"]
                                                  and a["reduce"]) or a["backend"] != "nccl":
        fail(f"[dist] nccl at world size 1: {a}")

    where = "two processes on one card"
    check_dist_dp(_dist_spawn("dp-train", _dist_train, 2, "gloo", tmp,
                              dist_train_config(DIST_ROWS), 1, DIST_STEPS), where)

    # _dist_spawn makes tmp / "dist_eval", where rank 0 leaves its embeddings
    ranks = _dist_spawn("eval", _dist_eval, 2, "gloo", tmp, str(tmp / "dist_eval"))
    with np.load(tmp / "dist_eval" / "dist_cat.npz") as z:
        dcat = {k: z[k] for k in z.files}
    check_dist_eval(ranks, dcat, device, where)
    emb_err = max(float(np.abs(dcat[k] - cat[k]).max() / max(np.abs(cat[k]).max(), 1e-30))
                  for k in ("g_t", "g_o", "l_t", "l_o"))
    masks_equal = all(np.array_equal(dcat[k], cat[k]) for k in ("o_mask", "t_mask", "t_len"))
    log(f"[dist] eval: gathered embeddings vs [serve]'s one-process run: max |err| / max "
        f"|value| {emb_err:.3e} (limit {TOL_BF16_CARD:g}), masks identical {masks_equal}")
    if emb_err > TOL_BF16_CARD or not masks_equal:
        fail("[dist] the gathered embeddings disagree with [serve]'s")

    check_dist_tp(_dist_spawn("tp", _dist_train, 2, "gloo", tmp, _tp_config(DIST_TP_ROWS), 2,
                              1), where)


def _gather_results(res: dict, keys) -> list:
    """Under torchrun: every rank's `keys` of `res`, in rank order; rank 0
    keeps its whole result (the one-process comparison)."""
    from demovlp_tpu_torch.parallel.mesh import host_allgather_pylist, process_index

    ranks = host_allgather_pylist([{k: res[k] for k in keys}])
    if process_index() == 0:
        ranks[0] = res
    return ranks


def _host_gather_cost(device, reps: int = 5) -> dict:
    """Median ms of one text-bucket agreement (all_reduce_max_int) issued
    while the card runs a spin kernel of SPIN_CYCLES: through the host
    gathers' gloo group, and the same integer all-gathered by NCCL on the
    card and read back (the path the gloo group replaced), which waits for
    the card."""
    import torch.distributed as dist

    from demovlp_tpu_torch.parallel.mesh import all_reduce_max_int, host_group, process_count

    times = {"gloo": [], "nccl": []}
    for _ in range(reps):
        for path in times:
            torch.cuda.synchronize()
            dist.barrier(group=host_group())
            torch.cuda._sleep(SPIN_CYCLES)
            t0 = time.perf_counter()
            if path == "gloo":
                all_reduce_max_int(dist.get_rank())
            else:
                t = torch.tensor([dist.get_rank()], device=device)
                parts = [torch.empty_like(t) for _ in range(process_count())]
                dist.all_gather(parts, t)
                max(int(x.cpu()) for x in parts)
            times[path].append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return {k: 1e3 * float(np.median(v)) for k, v in times.items()}


def _torchrun_epoch(world: int, out: Path) -> dict:
    """One epoch of the train CLI on ab_local_bf16_fast.json at 128 / world
    rows a rank (16 steps of the global 128, fenced)."""
    from demovlp_tpu_torch.cli.train import run
    from demovlp_tpu_torch.parallel.mesh import process_index, sync_processes

    cfg = json.loads(FAST_CFG.read_text())
    cfg["data_loader"]["args"]["batch_size"] //= world
    cfg["trainer"].update(epochs=1, save_dir=str(out / "fast"))
    path = out / "fast.json"
    if process_index() == 0:
        path.write_text(json.dumps(cfg))
    sync_processes()
    trainer = run(["-c", str(path)], fence_steps=True)
    return {"times": trainer.step_times, "losses": trainer.step_losses,
            "lens": trainer.step_text_lens}


def main_torchrun() -> None:
    """Under torchrun on N cards (N even), one process a card, NCCL: [dist]'s
    data-parallel, data-and-tensor-parallel and eval checks with each rank on
    its own card, the host gathers' cost, one -fast epoch (see the module
    docstring). Rank 0 checks; exit code 1 on any disagreement."""
    from demovlp_tpu_torch.device import resolve_device
    from demovlp_tpu_torch.parallel.mesh import (process_count, process_index,
                                                 setup_distributed, sync_processes)

    if os.environ.get("RANK", "0") == "0":
        kind, card = phase_device()
    device = resolve_device(None)
    setup_distributed("nccl")
    world, rank = process_count(), process_index()
    if world < 2 or world % 2:
        fail(f"--torchrun needs an even number of processes, not {world}")
    out = ROOT / "chiprun_out" / "chip_smoke" / "torchrun"
    if rank == 0:
        out.mkdir(parents=True, exist_ok=True)
        phase_build()
    sync_processes()
    where = f"{world} processes, one card each"
    rows = 2 * DIST_ROWS // world
    res = _dist_train(rank, dist_train_config(rows), 1, DIST_STEPS)
    ranks = _gather_results(res, ("losses", "launches", "times", "split"))
    if rank == 0:
        check_dist_dp(ranks, where)
    res = _dist_train(rank, _tp_config(DIST_TP_ROWS // (world // 2)), 2, 1)
    ranks = _gather_results(res, ("losses", "launches", "times", "split"))
    if rank == 0:
        check_dist_tp(ranks, where)
    res = _dist_eval(rank, str(out))
    ranks = _gather_results(res, ("launches", "embed_s", "sims_s", "n_local"))
    if rank == 0:
        with np.load(out / "dist_cat.npz") as z:
            dcat = {k: z[k] for k in z.files}
        check_dist_eval(ranks, dcat, device, where)
    cost = _host_gather_cost(device)
    if rank == 0:
        log(f"[torchrun] one bucket agreement beside a busy card (a spin of {SPIN_CYCLES:.0e} "
            f"cycles), median of 5: through the gloo host group {cost['gloo']:.3f} ms, "
            f"through NCCL on the card {cost['nccl']:.3f} ms")
    epoch = _torchrun_epoch(world, out)
    lens = _gather_results(epoch, ("lens",))
    if rank == 0:
        steps = epoch["times"]
        log(f"[torchrun] -fast epoch, {world} ranks of {rows} rows: {len(steps)} steps, "
            f"fenced step ms {[round(1e3 * t, 3) for t in steps]}, median of steps 2-"
            f"{len(steps)} {1e3 * float(np.median(steps[1:])):.3f} ms; losses "
            f"{[round(v, 5) for v in epoch['losses']]}; text lengths {epoch['lens']}")
        if len(steps) != 16 or not np.isfinite(epoch["losses"]).all():
            fail(f"[torchrun] -fast epoch: {len(steps)} steps, losses {epoch['losses']}")
        if any(r["lens"] != FAST_EPOCH1_LENGTHS for r in lens):
            fail(f"[torchrun] the ranks' text lengths {[r['lens'] for r in lens]} differ from "
                 f"the one-process epoch's {FAST_EPOCH1_LENGTHS}")
    sync_processes()
    if rank == 0:
        import shutil

        shutil.rmtree(out)
        log(f"[torchrun] done: {world} processes on {kind} ({card})")


def main() -> None:
    kind, card = phase_device()
    from demovlp_tpu_torch.device import resolve_device
    from demovlp_tpu_torch.ops import xattn_kernel as xk

    device = resolve_device("cuda")  # also turns TF32 off
    phase_build()
    err_small = phase_kernels(device)
    err_train = phase_kernels_train(device)
    err_f8 = phase_kernels_train(device, n=32, regions=240, seed=30)
    err_split = phase_kernels_splits(device)
    for errs in (err_train, err_f8):
        for k, v in err_split.items():
            errs[k] = max(errs[k], v)
    err_train[xk.KERNEL_BF16] = max(err_train[xk.KERNEL_BF16], err_f8[xk.KERNEL_BF16],
                                    phase_kernels_bf16_forward(device))
    err_fast = phase_kernels_buckets(device)
    err_attn = phase_kernels_attention(device)
    attn_launches = phase_attention_op(device)
    out_dir = ROOT / "chiprun_out" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp = Path(tmp)
        phase_reference(tmp)
        cat, serve_launches = phase_serve(tmp)
        phase_bf16(tmp, cat)
        query = phase_query(tmp, cat, device)
        phase_train_ref(device)
        trainer, train_launches = phase_train(tmp, device)
        phase_record(tmp, trainer)
        fast_trainer, fast_launches = phase_pretrain_fast(tmp, device, trainer)
        phase_mlm(tmp, device)
        phase_remat(device)
        phase_train_ref(device, "finetune-ref", _narrow_f8_config(tmp))
        ft_trainer, ft_launches = phase_finetune(tmp, device, trainer)
        rd_trainer, rd_launches, rd_inputs = phase_realdata(tmp, device, card, trainer,
                                                            ft_trainer)
        qa_trainer = phase_qa(tmp, device)
        phase_predict_qa(tmp, device, qa_trainer)
        del qa_trainer
        phase_mc(tmp, device)
        extractor = phase_extractor(device)
    inputs = phase_train_local(trainer)
    t = phase_timing(cat, device)
    tq = phase_timing({"l_o": query["gallery"]["l_o"], "o_mask": query["gallery"]["o_mask"],
                       "l_t": query["q"]["l_t"], "t_mask": query["q"]["t_mask"]}, device,
                      "query")
    tex = phase_timing(extractor["cat"], device, "extractor")
    fast_len = max(set(fast_trainer.step_text_lens), key=fast_trainer.step_text_lens.count)
    fast_local = fast_trainer.loss.local_loss
    tfast = phase_timing_train(_first_batch_local(fast_trainer, fast_len),
                               fast_local.focal_type == "equal",
                               fast_local.local_dtype == "bfloat16",
                               f"pretrain-fast Lq={fast_len - 1}", device)
    tt = phase_timing_train(inputs, trainer.loss.local_loss.focal_type == "equal", True, "train",
                            device)
    ft_local = ft_trainer.loss.local_loss
    tf8 = phase_timing_train(_first_batch_local(ft_trainer), ft_local.focal_type == "equal",
                             ft_local.local_dtype == "bfloat16", "finetune f=8", device)
    rd_local = rd_trainer.loss.local_loss
    trd = phase_timing_train(rd_inputs, rd_local.focal_type == "equal",
                             rd_local.local_dtype == "bfloat16", "msvd realdata", device)
    ta = phase_timing_attention(device)
    phase_step_split(trainer, device, "train")
    phase_step_split(ft_trainer, device, "finetune f=8")
    # after every other profiler run: a profiler run opened before the
    # card's first training step left later runs' key_averages without
    # the kernels launched through ctypes (the raw trace still held them)
    phase_profile(trainer, device, out_dir)
    phase_mfu(card, device, {"train": trainer, "pretrain-fast": fast_trainer,
                             "finetune f=8": ft_trainer})
    # last: every phase before it runs as it did before the parallel layer
    del trainer, fast_trainer, ft_trainer, rd_trainer, inputs, rd_inputs
    gc.collect()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        resume = phase_resume(Path(tmp), device)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        phase_dist(Path(tmp), device, cat)
    src = "demovlp_tpu_torch/csrc/"
    kernels = [{
        "name": "xattn_sim_fwd",
        "route": "cuda",
        "source": src + "xattn_sim_fwd.cu",
        # one count per direction runs three __global__ kernels
        "launch": "l2norm_rows_kernel (context rows), l2norm_rows_kernel "
                  "(query rows), xattn_sim_fwd_tf32_kernel",
        "replaces": "demovlp_tpu/ops/pallas_xattn.py:91",
        "launches": serve_launches,
        "max_abs_err": max(err_small, t["err"]),
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
    }, {
        "name": "xattn_sim_fwd_query",
        "route": "cuda",
        "source": src + "xattn_sim_fwd.cu",
        "launch": "l2norm_rows_kernel (context rows), l2norm_rows_kernel "
                  "(query rows), xattn_sim_fwd_tf32_kernel",
        "replaces": "demovlp_tpu/ops/pallas_xattn.py:91",
        "launches": query["launches"],
        "max_abs_err": max(query["err"], tq["err"]),
        "ms": tq["ms"],
        "plain_ms": tq["plain_ms"],
        "bound_ms": tq["bound_ms"],
        "bound_by": tq["bound_by"],
        "library_ms": None,
    }, {
        "name": "xattn_sim_fwd_extractor",
        "route": "cuda",
        "source": src + "xattn_sim_fwd.cu",
        "launch": "l2norm_rows_kernel (context rows), l2norm_rows_kernel "
                  "(query rows), xattn_sim_fwd_tf32_kernel",
        "replaces": "demovlp_tpu/ops/pallas_xattn.py:91",
        "launches": extractor["launches"],
        "max_abs_err": max(extractor["err"], tex["err"]),
        "ms": tex["ms"],
        "plain_ms": tex["plain_ms"],
        "bound_ms": tex["bound_ms"],
        "bound_by": tex["bound_by"],
        "library_ms": None,
    }]
    sources = {xk.KERNEL: ("xattn_sim_fwd.cu", "xattn_sim_fwd_tf32_kernel",
                           "demovlp_tpu/ops/pallas_xattn.py:91"),
               xk.KERNEL_BF16: ("xattn_sim_fwd.cu", "xattn_sim_fwd_bf16_kernel on (items, S) "
                                "blocks", "demovlp_tpu/ops/pallas_xattn.py:91 (mxu_bf16 mode)"),
               xk.KERNEL_DQ: ("xattn_sim_bwd.cu", "xattn_sim_bwd_dq_kernel on (items, S) "
                              "blocks, xattn_sim_bwd_dq_reduce_kernel",
                              "demovlp_tpu/ops/pallas_xattn.py:373"),
               xk.KERNEL_DC: ("xattn_sim_bwd.cu", "xattn_sim_bwd_dc_kernel on (items, S) "
                              "blocks, xattn_sim_bwd_dc_reduce_kernel",
                              "demovlp_tpu/ops/pallas_xattn.py:413")}
    for name, (file, main_kernel, replaces) in sources.items():
        for suffix, rows, launches, errs in (("", tt, train_launches, err_train),
                                             ("_fast", tfast, fast_launches, err_fast),
                                             ("_f8", tf8, ft_launches, err_f8),
                                             ("_msvd", trd, rd_launches, err_f8)):
            if name not in rows:  # f = 1 trains the bf16 forward, f = 8 the f32 one
                continue
            r = rows[name]
            norm = "l2norm_rows_bf16_kernel" if name == xk.KERNEL_BF16 else "l2norm_rows_kernel"
            kernels.append({
                "name": name + suffix,
                "route": "cuda",
                "source": src + file,
                "launch": f"{norm} (context rows), {norm} (query rows), {main_kernel}",
                "replaces": replaces,
                "launches": launches[name],
                "max_abs_err": errs[name],
                "ms": r["ms"],
                "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                "library_ms": None,
            })
    for name, (file, main_kernel, replaces) in sources.items():
        if name == xk.KERNEL:
            continue
        r = resume["timing"][name]
        norm = "l2norm_rows_bf16_kernel"
        kernels.append({
            "name": name + "_block",
            "route": "cuda",
            "source": src + file,
            "launch": f"{norm} (context rows), {norm} (query rows), {main_kernel}",
            "replaces": replaces,
            "launches": resume["launches"][name],
            "max_abs_err": resume["errs"][name],
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
        "launch": "grouped_attention_mma_kernel<64> (bf16, each of the four shapes)",
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
        "those of the 16-step train run; the _f8 rows (the f32 forward and the backward "
        "kernels): one fine-tune step's two launches at 32x32 (f = 8, f32 mode), launches those "
        "of the 16-step fine-tune run (the forward's include validation); the _msvd rows: the "
        "same on the real-data run's first batch (MSVD ids and captions, npz regions through "
        "the native decode), launches those of its 16 steps and two validations, max_abs_err "
        "that of the f = 8 checks; the _fast rows (the bf16 forward and the backward "
        f"kernels): one -fast pre-training step's two launches at its most frequent bucket "
        f"({fast_len} tokens, Lq = {fast_len - 1}), launches those of its 16-step run, "
        "max_abs_err that of the bucket-shape checks; xattn_sim_fwd_query: one query call's "
        "local sims (64 queries x 1000 videos, both directions), launches those of that "
        "call; xattn_sim_fwd_extractor: the local sims of the extractor's 64 videos and their "
        "64 captions (both directions), launches those of its combined_sims; an f32-mode bound "
        f"counts {TF32_PASSES} TF32 passes at {PEAK_TF32_FLOPS:.3g} FLOP/s, a bf16 one the bf16 "
        "peak; "
        "max_abs_err of the training kernels is the worst of the training-shape checks (the "
        "backward kernels' with the ragged-split checks); the "
        "row-norm kernel's time is included in ms; no single PyTorch call computes the local "
        "similarity, so its library_ms is null. grouped_attention: ms, plain_ms, bound_ms and "
        "library_ms (scaled_dot_product_attention) summed over one tower layer's four grouped "
        "shapes in bf16; launches those of the attention-op phase; the _block rows (the "
        f"blocked local loss, local_block_segment {RESUME_SEGMENT}): one block's two launches, "
        f"{RESUME_SEGMENT} images x 128 captions and 128 x {RESUME_SEGMENT}, on [resume]'s "
        "first batch (a step runs 128 / 32 = 4 blocks), launches those of [resume]'s "
        "in-process 8-step async run, max_abs_err that of the block-shape checks")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main_torchrun() if sys.argv[1:] == ["--torchrun"] else main()
