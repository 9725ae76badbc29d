#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--steps 2000] [--profile 0] [--first DIR]

Phases (any failure exits non-zero):
1. device and build: the card's name and power limit; builds the fused
   encode+MLP, features-in forward and backward kernels, the NGP
   brick-encode and fused encode+MLP eval kernels, the brick training
   encode with its table gradient and the gather probes from csrc/, one
   nvcc each, all started together, and prints the build time and ptxas's
   register and spill report.
2. kernel against its plain PyTorch version, with the data/pretrain/hard
   weights, at the render path's point counts: 2.56M (a 40000-ray coarse
   chunk) and 7.68M (a fine chunk); error statistics and CUDA-event times.
   Two lower-precision variants of the plain version must fail the same
   check, which shows that it can see a precision fault.
3. the slice: ``run_evaluate`` on configs/nerf/hard.yaml with
   data/pretrain/hard, on hard-scene test views 0 and 4 at 800x800 whose
   ground truth ``render_gt`` makes on the card; mean uint8 PSNR against
   the JAX package's 31.75 dB from the same checkpoint; view 0 again with
   the kernel off (the plain MLP) and the PSNR between the two renders;
   frame times, the kernel's launches (2 per ray chunk) and the plain
   MLP's calls (0 with the kernel on, 2 per chunk with it off).
4. the training kernels against their plain versions on one real
   1024-ray batch of the hard scene (its train views rendered on the card)
   with the data/pretrain/hard weights: 65536 coarse and 196608 fine
   points. The features-in forward is held to phase 2's check; the
   backward, given the batch's real dloss/draw, by its bf16 deltas against
   the plain version's element by element, its weight-gradient sums
   against float64 sums of its own workspace, and every weight and bias
   leaf against the plain backward in relative norm, with exactly zero
   gradients on the padding. Two faulty plain backwards (deltas kept in
   f32; the density head's path into the trunk dropped) must fail that
   check. CUDA-event times of kernel and plain at both shapes.
5. training: configs/nerf/hard.yaml at full width from a fresh init
   (seed 0) on 20 of the hard scene's 100 train views at 800x800, 2000
   steps (four 500-step epochs, the first under precrop) through the fused
   kernels, and again through the nn.Module MLP. Per arm: rays/s, the
   smoothed loss and train PSNR, peak memory, and the eval PSNR on hard
   test views 0 and 4 through the eval renderer; the kernel arm makes 2
   forward and 2 backward launches a step and no plain call, the
   nn.Module arm no launch; both final PSNRs above the floor stated in
   PERF.md, and the arms' mean PSNR at the ends of the last two epochs
   within 0.5 dB of each other; a checkpoint of the kernel arm loads back
   through load_network and renders the same image.
   ``--steps`` shortens the run for a quick check; ``--profile N``
   profiles N more steps of each arm with torch.profiler, and 5 frames of
   phase 6's fused route and N more steps of phase 7's kernel arm (tables
   under build/). ``--first DIR`` builds the brick gather kernels' first
   designs from the csrc directory DIR and times them in phases 6 (a) and
   7 (a) beside the present ones (:func:`build_first_designs`).
6. NGP eval: configs/nerf/hard_ngp.yaml with data/pretrain/hard_ngp_b9
   (``network.xyz_encoder.log2_bricks 9``). (a) The brick-encode kernel and
   both arms of the fused encode+MLP kernel (f32 in 3xTF32, bf16) against
   their plain versions on the samples of one real 8000-ray chunk of hard
   view 0 (384,000 coarse and 896,000 fine points, each through its
   branch), with four lower-precision plain versions that must fail the
   same check (the table read in f32, the f32 MLP in bf16 and in TF32, and
   the f32 arm against the bf16 check) and the 3xTF32 emulation of the f32
   arm's products beside them; then the f32 arm on a 16-level network
   (configs/nerf/lego_ngp.yaml, seeded random weights and table) at the
   fine chunk's points; CUDA-event times beside each kernel's bound (the
   f32 arm's at the TF32 and at the CUDA-core f32 rate). The encode reads
   the cell-corner table and must equal, bit for bit, its plain version
   and the plain version from the packed table; beside its time (the
   median of five rounds, with their spread) its time with the host's
   issue time, the first design's, and the L2 sectors a (point, level) of
   its design and of the first one on these points with the L2 rate they
   imply. (b)
   ``run_evaluate`` on hard test views 0 and 4 at 800x800 through the fused
   route: mean uint8 PSNR against the JAX record 30.28 dB, SSIM, frame
   times, 2 fused launches a chunk and no other kernel or plain call, the
   device busy ms of one profiled frame. (c) View 0 through the fused
   kernel's bf16 arm (2 launches a chunk), the unfused route (the encode
   kernel and the nn.Module MLP, 2 of each a chunk) and the plain route
   (``network.use_pallas_mlp False``: the nn.Module network, whose encoder
   launches the training forward kernel, 2 a chunk): each one's PSNR
   against the fused render, its frame time and (bf16, unfused) its
   device busy ms a frame.
7. NGP training: configs/nerf/hard_ngp.yaml as committed (12 levels,
   ``log2_bricks`` 12, a 34432 x 256 f32 table, 1024 rays, 48 + 64
   samples, ``random_bkgd``) on the 20 train views of phase 5 with their
   alphas. (a) The training forward and the table-gradient kernel against
   their plain versions on the sample points of one real batch (49,152
   coarse and 114,688 fine points) of a network 200 steps from its
   seed-0 init, with the loss's own gradient, at the config's layout and
   at ``log2_bricks`` 13, whose levels of 8064 and 8192 rows take the f32
   branch: the forward bit for bit (the plain version with the table read
   in f32 must differ), the gradient against the plain backward summed in
   f64, every level within 1e-5 of its max |gradient| (f32 atomic sums in
   any order), the padding exactly zero; the plain backward with f32
   contributions on the bf16 levels, and with bf16 by truncation, must
   fail that check. CUDA-event times beside the bounds, the time of one
   ``index_add_`` over the same (address, value) pairs, and the share of
   them that the kernel's warp merge folds away; beside the forward's time
   (median and spread) the same readings as in phase 6 (a), for the first
   design's thread map and this one. (b) 2000 steps
   from a fresh init (seed 0) through the train CLI's ``train()``, four
   epochs, each after the first resumed from the checkpoint: rays/s, peak
   memory, 2 forward and 2 backward launches a step and no plain call,
   eval PSNR of hard test views 0 and 4 through the fused NGP eval kernel
   after every epoch, the last above the floor in PERF.md. (c) The first
   1000 of those steps with the encode forced to its plain forward and
   backward (~170 ms a step, so half the steps): no launch, the arms'
   mean eval PSNR over steps 500 and 1000 within 0.5 dB. (d) The kernel
   arm's checkpoint read back: every parameter (the table too) and every
   optimizer moment bit for bit, and the same render. Cut for time: 20 of
   100 views, 2000 of the schedule's steps.
8. the gather probes (scripts/probe_cuda_gather.py): row, element and
   lane gathers and atomic adds at two contention levels against PyTorch
   indexing, each with its time, the PyTorch call's and its byte bound.
9. the frame path: the occupancy-raymarch frame renderer
   (``ngp_renderer.make_ngp_frame_renderer``) at 800x800 on hard test
   views 0 and 4, for data/pretrain/hard through the encode+MLP kernel
   and data/pretrain/hard_ngp_b9 through the fused NGP kernel's f32 arm,
   then its bf16 arm. (a) The grids (64^3 dilated 2, 128^3 dilated 1)
   through the kernel, their occupied shares and build time beside the
   JAX record's, and the kernel against its plain version at both
   lattices in the build's 65,536-point chunks: the raw outputs within
   the family's bounds, and a cell may flip only where the plain density
   lies within the check's elementwise bound of the threshold. (b) The
   gated frame (``raymarch_bench.gated_frame``): the ladder from the JAX
   record's passing step, with autocap, walking on only if it fails; the
   gate is the mean uint8 test PSNR within 0.2 dB of phase 3's / phase
   6's dense render (reused, not rendered again); the step, the PSNRs,
   the stats beside the JAX record's; for NGP the bf16 arm at the passing
   step, gated the same way and adopted only if it passes. (c) One
   frame's launches (the kernel alone, as many as the frame's ray budget
   asks); the kernel against its plain version on the samples one frame
   gives it (its first coarse and first fine chunk); a warmed frame under
   ``torch.cuda.set_sync_debug_mode("error")``; seconds a frame
   synchronised (median of 40, with the host's issue time) beside the
   dense frame, and frames with one of overlap (``raymarch_bench``'s
   timing) over two windows of 100 orbit frames; the truncated frames'
   times by stage, peak memory, the device busy ms and idle share of one
   profiled frame. The times come after phases 3 and 6 have run
   torch.profiler, which leaves the process's later launches slower
   (scripts/frame_host_time.py): the host-bound NGP frame reads above a
   fresh process's (raymarch_bench.py's).
   (d) NGP: (c)'s launches, chunk checks and times for the bf16 arm.
10. the compacted frequency frame (``Renderer.make_frame_renderer``,
   ``raymarch_bench.compact_frame``, bench.py's ``freq`` family) at 800x800
   through #1/#2, beside the JAX record (result/bench_freq_r5.log). (a)
   The 64^3 grid (threshold 0.05, dilated 2) through #1, its occupied
   share. (b) The frame of orbit pose 0 at capacity 0.35 / coarse 0.4,
   then autocap; its stats. (c) The ERT gate (the 2-segment frame against
   the 1-segment one, >= 45 dB), then the GT-drop of both on hard test
   views 0 and 4 against phase 3's dense render (the adopted one <= 0.2
   dB). (d) #1 against its plain version on the frame's first coarse and
   first fine chunk and both ERT segments of its first fine chunk. (e)
   ``render_image_fast`` through ``run_evaluate`` with
   ``task_arg.fast_sampling`` on views 0 and 4, within 0.02 dB of phase
   3's PSNR, through #1. (f) One real 1024-ray training batch with
   ``fast_sampling``: #3 and #5 against plain within phase 4's bounds,
   then the fused arm against the nn.Module arm (loss, leaf gradients).
   (g) One ERT frame's launches (#1 alone), a warmed frame under
   ``set_sync_debug_mode("error")``, synchronised frames (median of 40,
   with the host's issue time) and two 100-frame windows, each for the ERT
   frame and the 1-segment one, the device busy ms and idle share of one
   profiled ERT frame.
11. the vertex-exact ``xla`` hash grid (plain PyTorch: the JAX package
   runs it in XLA, no Pallas kernel) and the composite encoders. (a)
   configs/nerf/hard_ngp.yaml with ``network.xyz_encoder.backend xla`` (12
   levels, 6 hashed at 2^19 rows: 3,963,248 x 2, a seeded U(-1, 1) table)
   on the points of one real 1024-ray batch (49,152 coarse and 114,688
   fine) and of one 8000-ray eval chunk of view 0 (384,000 and 896,000):
   the corner rows bit-equal to the CPU's, the forward against the CPU's
   float64 sum of the same products, the bf16 arm against its own CPU run;
   on the training points also the table gradient (a seeded cotangent)
   against float64 sums of its contributions, every row within its
   worst-case summation bound, and the input gradient against the CPU's
   float32 run; CUDA-event times of the forward and backward beside the
   byte bound, one ``index_add_`` of the contributions and a sort of
   their rows, and #6/#7 on the same points. (b) 2000 steps of that
   config from a fresh init (seed 0) through ``train()`` in four epochs,
   each after the first resumed: rays/s, peak memory, no kernel launched
   (the nn.Module and the xla encode, 2 calls a step), eval PSNR of hard
   test views 0 and 4 after each epoch beside phase 7's brick arm, the
   last above the NGP floor, the checkpoint read back bit for bit. (c)
   ``run_evaluate`` of views 0 and 4 from that checkpoint, densely at
   800x800: the trained network's images bit for bit, frame times, the
   device busy ms and idle share of one profiled frame. (d) the 11
   composite and D-NeRF encoder names at the reference's defaults (16
   levels, ``log2_hashmap_size`` 19; dnerf W 256, D 8; 3 frames) on
   65,536 seeded points: forward, every parameter gradient and the points'
   on the card against the CPU in float64, and the card's float32 run
   against its float64 one (reported).
12. the host loader (``make_data_loader``, ``Trainer.train``). (a)
   configs/img_fit/lego_view0.yaml as committed (D 4, W 128, 10 bands,
   8192 pixels a step, Adam 5e-4) on one 800x800 view of the hard scene
   that ``generate_scene`` writes on the card, 2 epochs of 500 steps
   through ``train()`` from the JAX init data/pretrain/img_fit_init with
   dataset seed 0 (overridden: data_root, scene, the epoch count, the seed,
   and ``eval_ep`` 1 for an eval at each epoch end): the eval PSNR at each
   epoch end, the epoch-2 one within 0.2 dB of the JAX package's reading
   of the same run on the CPU (scripts/img_fit_jax_reference.py), pixels/s,
   the data time's share of the wall, peak memory; no kernel runs. (b)
   configs/nerf/hard.yaml on phase 5's 20 train views as a Blender train
   split (each item 1024 pixels of one view): the first host batch's loss
   and leaf gradients through #3-#5 against the nn.Module arm (phase 10
   (f)'s bounds), then 200 steps of ``Trainer.train`` from the seed-0 init:
   2 launches of #3/#4 and 2 of #5 a step, no plain call, a finite loss,
   steps/s and the data time's share. (c) With ``--profile``, 20 more
   host-loader steps of each under torch.profiler
   (build/profile_host_loader_{img_fit,nerf}.txt).
13. data parallel (``parallel.mesh``). (a) One rank over nccl in this
   process against no group: 20 steps of configs/nerf/hard.yaml at full
   width on phase 5's views through #3-#5, losses and parameters bit for
   bit. (b) ``chip_smoke.py --dp_rank`` as N ranks (2 sharing one card over
   gloo, else nccl over min(count, 4) cards; every rank killed if one
   fails or the group outlives its limit): the same 20 steps at the same
   global batch of 1024 rays against the one-process run (per-step losses
   within 1e-4 over the first 2 steps and DP_LOSS_RTOL over the 20, the
   largest parameter difference), two faulty controls that must miss
   (a sum without the division, ranks that draw their own rays);
   hard_ngp.yaml as committed for 20 steps through #6/#7, the first step's
   table gradient after the all-reduce against one process within
   BRICK_BWD_TOL of each level's max; the dense eval of hard view 0
   through #1 (``run_evaluate``) against phase 3's render, the compacted
   ERT frame (#1) and the NGP frame-path frame (#10) of orbit pose 0
   against one rank's, with the JAX tests' bounds and the share of
   bit-equal pixels; each kernel's launches a rank (the training kernels
   as one process's, the render kernels summing to one rank's); the step
   time of one process and of N ranks (with one card, two processes
   time-sharing it: not a scaling figure). (c) ``parallel.dryrun`` on 2
   ranks under ``torch.distributed.run``: its f32 and bf16 arms and
   controls.
Every CUDA-event time is the median of five rounds after one warm-up
call (``cuda_times``). The last three lines are the card's name and power
limit, the kernel summary (each kernel's launches on its path, error,
times and bound; ``frame_launches`` for the frame path's kernels: their
launches in one frame, ``compact_frame_launches`` #1's in one compacted
frame; under ``plain_pytorch`` the xla encode, which is no kernel: its
calls in phase 11's training, errors, times and bounds; #3/#4 and #5
also under ``host_loader_launches``, their launches in phase 12 (b); the
kernels of phase 13 under ``dp_launches_by_rank``) and the device, the
last two as JSON.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time
from typing import NamedTuple
from unittest import mock

import numpy as np
import torch


class Bounds(NamedTuple):
    """A kernel-against-plain check (see :func:`agreement`)."""
    col_rtol: float       # every element within col_rtol x its column's max
    atol: float           # the elementwise bound ...
    rtol: float
    outlier_frac: float   # ... that at most this share of elements exceeds
    median_rtol: float    # each column's median error / its max


# Kernel against plain: the same rounding points, so they differ only where
# the f32 summation order flips a bf16 rounding of an activation. Most
# outputs then agree to f32 rounding; with the trained weights activations
# reach ~1e3, where one bf16 step is 4-8, so a flip moves an output by an
# amount that scales with its column's range, not with the element. Three
# bounds, each set from the H100 readings with room:
# - every element within COL_RTOL x its column's max |plain| (read <= 6.1e-3);
# - at most OUTLIER_FRAC of the elements outside the JAX tests' elementwise
#   bound, atol 2e-2 + rtol 5e-2 (read <= 4e-7);
# - each column's median error within MEDIAN_RTOL x its max |plain| (read
#   ~1e-8: the median element matches to f32 rounding).
# CONTROLS are the plain version at a lower precision; the check must
# reject each of them (the first passed the two looser bounds alone).
KERNEL_ATOL, KERNEL_RTOL = 2e-2, 5e-2
COL_RTOL = 1e-2
OUTLIER_FRAC = 1e-5
MEDIAN_RTOL = 1e-6
MLP_BOUNDS = Bounds(COL_RTOL, KERNEL_ATOL, KERNEL_RTOL, OUTLIER_FRAC,
                    MEDIAN_RTOL)
JAX_PSNR_DB = 31.75     # dense test PSNR of data/pretrain/hard, JAX record
PSNR_BUDGET_DB = 0.1
KERNEL_VS_PLAIN_MIN_DB = 55.0   # read 65.17 dB
POINTS = (2_560_000, 7_680_000)  # 40000 rays x 64 and x 192 samples
ROOT = os.path.dirname(os.path.abspath(__file__))

# Training path. Backward kernel against plain, on the same rounding
# points, so they differ only where the f32 summation order flips a bf16
# rounding of a delta. Three parts, bounds set from the readings with room
# (PERF.md section 6):
# - the bf16 deltas the kernel leaves in its workspace against the plain
#   version's, plane by plane: at most DELTA_DIFF of the elements may
#   differ at all (read <= 2.0e-4 on the H100, <= 1.3e-3 for a change of
#   summation order on the CPU; the f32-delta control >= 4.7e-2);
# - the weight-gradient kernel against float64 products of the kernel's
#   own workspace, every leaf within WGRAD_REL in relative norm;
# - every weight and bias leaf against the plain backward within GRAD_REL
#   in relative norm (summation-order flips move a leaf by up to ~6e-3;
#   a structural fault by O(1)), finite, and exactly zero on the padding.
# GRAD_CONTROLS are faulty plain backwards that the check must reject.
DELTA_DIFF = 5e-3
WGRAD_REL = 1e-5
GRAD_REL = 2e-2
TRAIN_VIEWS = list(range(0, 100, 5))  # 20 of the 100 train views
TRAIN_STEPS = 2000                    # four epochs of ep_iter steps
TRAIN_PSNR_FLOOR_DB = 18.0            # the prediction in PERF.md section 6
# The arms are compared on the mean eval PSNR at the ends of the last two
# epochs: one run's eval PSNR swings by 0.5-0.9 dB from one epoch end to
# the next at this stage, and over three seeds and four end points the
# arms differ by -0.035 dB on average (PERF.md section 6).
ARMS_MAX_DIFF_DB = 0.5
TRAIN_ARGV = ["--cfg_file", "configs/nerf/hard.yaml", "device", "cuda",
              "seed", "0", "train.epoch", "4", "save_result", "False",
              "resume", "False", "trained_model_dir", "build/smoke_train",
              "record_dir", "build/smoke_record"]
CKPT_DIR = os.path.join(ROOT, "build", "smoke_ckpt")

# NGP eval (phase 6), in float32. The encode kernel sums the same bf16
# table values in the same order with the same roundings as its plain
# version (read: bit-equal); the fused MLP's f32 arm (3xTF32 products)
# differs from the plain one (f32 products) by the ~2^-22 a product that
# 3xTF32 drops and by f32 summation order: the first kernel (fmaf chains)
# read <= 6.1e-7 of a column's range, the 3xTF32 emulation 1.2e-6 on the
# CPU (PERF.md section 6). The controls (NGP_CONTROLS) read 2.9e-3 (table
# in f32), 2.0e-2 (MLP in bf16) and 3.0e-3 (MLP in TF32) of the range.
NGP_BOUNDS = Bounds(col_rtol=1e-5, atol=1e-4, rtol=1e-4, outlier_frac=1e-5,
                    median_rtol=1e-6)
# The bf16 arm against its plain version (bf16 operands, exact products,
# f32 sums): they differ where the f32 summation order flips the bf16
# rounding of an activation, so MLP_BOUNDS' three bounds, set from the
# H100 readings at 384,000 / 896,000 points with room: col 5.4e-3 /
# 4.4e-3, outside atol + rtol 2.0e-6 / 2.8e-7, column medians 0. The f32
# arm's plain version, the control, read col 1.4e-2, outside 2.1e-2,
# medians 1.4e-3.
NGP_BF16_BOUNDS = Bounds(col_rtol=1e-2, atol=2e-2, rtol=5e-2,
                         outlier_frac=1e-5, median_rtol=1e-6)
NGP_BF16_MIN_DB = 55.0    # the bf16 arm's render against the f32 one (60.06)
NGP_16_LEVELS = ("--cfg_file", "configs/nerf/lego_ngp.yaml", "device", "cuda")
NGP_ARGV = ["--type", "evaluate", "--cfg_file", "configs/nerf/hard_ngp.yaml",
            "pretrain_path", "data/pretrain/hard_ngp_b9",
            "network.xyz_encoder.log2_bricks", "9", "save_result", "False",
            "device", "cuda"]
NGP_JAX_PSNR_DB = 30.28   # dense test PSNR of hard_ngp_b9, JAX record
NGP_ROUTES_MIN_DB = 60.0  # unfused and plain render against the fused one
NGP_CHUNK = 40            # the ray chunk of view 0 phase 6 (a) checks
NGP_PROFILE_FRAMES = 5    # fused frames of view 0 under --profile
FREQ_PROFILE_FRAMES = 3   # dense frequency frames of view 0 under --profile

# NGP training (phase 7), in float32. The training forward sums the
# plain version's products in its order, one rounding each: bit-equal.
# The table gradient adds the plain backward's contributions with
# atomicAdd, so it differs from an order-free f64 sum of them by f32
# summation order alone, by far less than BRICK_BWD_TOL of a level's max
# |gradient| (the readings are in PERF.md section 6); a fault in the
# contributions' rounding moves a level by ~1e-3 (BRICK_BWD_CONTROLS).
BRICK_BWD_TOL = 1e-5
NGP_WARM_STEPS = 200       # steps before phase 7 (a) takes its batch
NGP_LAYOUTS = (12, 13)     # log2_bricks: the config's; one with f32 levels
NGP_TRAIN_PSNR_FLOOR_DB = 20.0    # the prediction in PERF.md section 6
NGP_ARMS_MAX_DIFF_DB = 0.5
NGP_PLAIN_STOPS = (1, 2)   # the plain arm's epochs: half the kernel arm's
NGP_TRAIN_ARGV = ["--cfg_file", "configs/nerf/hard_ngp.yaml", "device",
                  "cuda", "seed", "0", "save_result", "False", "save_ep",
                  "1000", "eval_ep", "1000", "save_latest_ep", "1",
                  "record_dir", "build/smoke_ngp_record"]

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W): a
# kernel's bound is the larger of its bytes over the memory rate and its
# operations over the rate of their type.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "tf32": 494.7e12, "f32": 67e12}


def bound(n_bytes: float, n_ops, kind: str | None = None) -> dict:
    """``bound_ms`` and ``bound_by`` for moving ``n_bytes`` and doing
    ``n_ops`` operations of type ``kind``, or ``n_ops`` a dict of
    operations by type (their times add up)."""
    ops = n_ops if kind is None else {kind: n_ops}
    ms_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    ms_ops = sum(n / PEAK_OPS_PER_S[k] for k, n in ops.items()) * 1e3
    return {"bound_ms": max(ms_bytes, ms_ops),
            "bound_by": "bytes" if ms_bytes >= ms_ops else "operations"}


# Times of the first version of the 8x256 MLP kernels (wmma, 64-point
# tiles, weights read from L2 by every block) and of the brick gather
# kernels (the eval encode: a thread a point, 4-byte corner loads from the
# packed table; the training forward: a thread a (point, level), the level
# running fastest) at the same point counts, on an NVIDIA H100 80GB HBM3
# at 700 W: printed beside the present kernels'. The brick kernels' are
# their readings before the redesign (one round, no warm-up);
# ``--first DIR`` times those designs in this run instead
# (:func:`first_brick_design`).
FIRST_VERSION_MS = {
    ("enc", 2_560_000): 24.77, ("enc", 7_680_000): 73.23,
    ("fwd", 65_536): 0.657, ("fwd", 196_608): 1.946,
    ("bwd", 65_536): 3.470, ("bwd", 196_608): 9.887,
    ("encode", 384_000): 0.1053, ("encode", 896_000): 0.1987,
    ("brick_fwd", 49_152): 0.0652, ("brick_fwd", 114_688): 0.0465}
# kind ("encode", "brick_fwd") -> C function of the brick gather kernels'
# first designs, built from ``--first DIR`` (:func:`build_first_designs`)
FIRST_DESIGNS: dict = {}
SMEM_LIMIT = 232_448   # dynamic shared memory a block may use on the card


def against_first(kind: str, n: int, reading: dict) -> str:
    """A reading (ms, bound_ms) beside its bound and the first version's
    time at this size."""
    first = FIRST_VERSION_MS.get((kind, n))
    was = f"first version {first} ms, " if first else ""
    return (f"{was}bound {reading['bound_ms']:.3f} ms by "
            f"{reading['bound_by']} ({reading['bound_ms'] / reading['ms']:.1%}"
            f" of it reached)")


def build_first_designs(csrc) -> dict:
    """Build the brick gather kernels' first designs from the csrc
    directory ``csrc`` (the sources of commit 78b2f3b: ``git archive 78b2f3b
    nerf_replication_tpu_torch/csrc | tar -x -C build/first``) into
    build/first/, one nvcc each, all started together; their C interfaces
    are the present kernels', the eval encode reading the packed table.
    Returns kind -> C function, for ``FIRST_DESIGNS``."""
    from nerf_replication_tpu_torch.ops import _build

    out = os.path.join(ROOT, "build", "first")
    os.makedirs(out, exist_ok=True)

    def one(name):
        lib = os.path.join(out, f"lib{name}.so")
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                               os.path.join(csrc, f"{name}.cu")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            fail(f"the first design's {name}.cu does not build:\n"
                 f"{proc.stderr}")
        return ctypes.CDLL(lib)

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        enc, fwd = pool.map(one, ("brick_encode_eval", "brick_hash_encode"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    enc.brick_encode_eval.argtypes = [ptr, ptr, ptr, i32, ptr, i32, ptr]
    fwd.brick_hash_encode_fwd.argtypes = [ptr, ptr, ptr, i32, ptr, i32,
                                          ctypes.c_uint32, ptr]
    return {"encode": enc.brick_encode_eval,
            "brick_fwd": fwd.brick_hash_encode_fwd}


def first_brick_design(kind: str, layout, table, x, ref) -> tuple:
    """(ms, text) of the first design of brick kernel ``kind`` ("encode":
    ``table`` the packed table; "brick_fwd": the f32 table) on the points
    ``x``: with ``--first``, launched here, held bit for bit to ``ref``
    and timed as the present kernel is; otherwise its reading in
    FIRST_VERSION_MS (None where there is none for these points)."""
    from nerf_replication_tpu_torch.ops import hashgrid_kernel as hk

    n = x.shape[0]
    launch = FIRST_DESIGNS.get(kind)
    if launch is None:
        ms = FIRST_VERSION_MS.get((kind, n))
        return ms, (f"first design {ms} ms (its reading before the "
                    f"redesign, one round); " if ms else "")
    out = torch.empty_like(ref)
    args = [x.data_ptr(), table.data_ptr(), out.data_ptr(), n,
            ctypes.byref(hk.kernel_levels(layout)), len(layout.scales)]
    if kind == "brick_fwd":
        args.append(hk._bf16_mask(layout))

    def run():
        err = launch(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            fail(f"the first design's {kind} kernel failed to launch ({err})")

    run()
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        fail(f"the first design's {kind} kernel differs from plain, N={n}")
    times = cuda_times(run, 20)
    return (times[TIMING_ROUNDS // 2],
            f"first design, this run: bit-equal, {spread(times)}; ")


def gather_sectors(layout, x, first: str, now: str) -> dict:
    """The 32-byte L2 sectors a (point, level) of the points ``x`` costs:
    in the table layout ``now`` with this design's thread map (a warp's
    lanes are 32 consecutive points at one level), and in the first
    design's layout ``first`` with its map (the same for the eval encode's
    packed table; a thread a (point, level), the level running fastest,
    for the training forward). Sectors are counted per warp-wide request,
    as ``merged_share`` counts merges."""
    from nerf_replication_tpu_torch.ops import brick_tile as bt

    n, levels = x.shape[0], len(layout.scales)
    first_units = (bt.warp_level_units if first == "packed"
                   else bt.level_fastest_units)
    res = {"lookups": n * levels}
    for key, table, units in (("first", first, first_units),
                              ("now", now, bt.warp_level_units)):
        res[key] = bt.sectors_per_lookup(bt.corner_bytes(layout, x, table),
                                         units(n, levels).to(x.device))
    return res


def describe_sectors(gathers: dict, ms: float, first_ms=None) -> str:
    """Sectors a (point, level), now and in the first design, and the L2
    rate they imply at this time and at the first design's time
    ``first_ms``, where there is one for these points."""
    def rate(sectors, t):
        return sectors * 32 * gathers["lookups"] / (t * 1e-3) / 1e12

    was = (f" (first design {rate(gathers['first'], first_ms):.2f} TB/s at "
           f"its {first_ms} ms)" if first_ms else "")
    return (f"L2 sectors a (point, level) {gathers['now']:.3f} (first design "
            f"{gathers['first']:.3f} on these points), implied L2 rate "
            f"{rate(gathers['now'], ms):.2f} TB/s{was}")


def mlp_flops(mlp) -> int:
    """2 x the multiply-adds of one point through an MLP's unpadded
    weights."""
    return 2 * sum(p.numel() for name, p in mlp.state_dict().items()
                   if name.endswith("weight"))


def input_side_flops(mlp, x_dim: int, v_dim: int) -> int:
    """2 x the multiply-adds of one point through the weight rows that read
    the inputs x and v: all of pts.0, the x rows of each layer after a
    skip (the heads' too when the last layer skips) and the v rows of
    views.0. A backward that returns no input gradients forms no deltas
    through them."""
    state = mlp.state_dict()
    readers = ["pts.0"] + [f"pts.{s + 1}" for s in mlp.skips
                           if s + 1 < mlp.depth]
    if mlp.depth - 1 in mlp.skips:
        readers += ["alpha", "feature"]
    macs = sum(state[f"{r}.weight"].shape[0] * x_dim for r in readers)
    return 2 * (macs + state["views.0.weight"].shape[0] * v_dim)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _truncate_bf16(x: torch.Tensor) -> torch.Tensor:
    """bf16 by dropping the low 16 bits: rounding toward zero."""
    return (x.float().contiguous().view(torch.int32) & -65536).view(
        torch.float32)


CONTROLS = {
    "f32 activations (no bf16 rounding)": lambda x: x.float(),
    "bf16 by truncation": _truncate_bf16,
}


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def agreement(out: torch.Tensor, ref: torch.Tensor,
              bounds: Bounds = MLP_BOUNDS) -> dict:
    """The kernel-against-plain check on (N, C) outputs: its statistics,
    and ``ok`` when all three bounds hold and ``out`` is finite."""
    err = (out - ref).abs()
    col_max = ref.abs().amax(dim=0).clamp_min(1e-30)
    col = float((err.amax(dim=0) / col_max).max())
    outside = float((err > bounds.atol + bounds.rtol * ref.abs())
                    .float().mean())
    median = float((err.median(dim=0).values / col_max).max())
    ok = (bool(torch.isfinite(out).all()) and col <= bounds.col_rtol
          and outside <= bounds.outlier_frac and median <= bounds.median_rtol)
    return dict(ok=ok, max_abs_err=float(err.max()), col=col,
                outside=outside, median=median, bounds=bounds,
                col_max=[round(float(c), 1) for c in col_max])


def describe(a: dict) -> str:
    b = a["bounds"]
    return (f"max_abs_err {a['max_abs_err']:.3e}, max err / column max "
            f"|plain| {a['col']:.2e} (<= {b.col_rtol}), outside atol "
            f"{b.atol} + rtol {b.rtol}: {a['outside']:.2e} "
            f"(<= {b.outlier_frac}), column median err / column max |plain| "
            f"{a['median']:.2e} (<= {b.median_rtol}), column max |plain| "
            f"{a['col_max']} {'ok' if a['ok'] else 'FAIL'}")


def control_plain(round_fn, *args) -> torch.Tensor:
    """The plain version with its bf16 rounding replaced by ``round_fn``."""
    from nerf_replication_tpu_torch.ops import mlp_kernel

    with mock.patch.object(mlp_kernel, "_bf16", round_fn):
        return mlp_kernel.fused_nerf_mlp_enc_reference(*args)


TIMING_ROUNDS = 5
SPIN_CYCLES_PER_S = 2e9   # the H100's clock, rounded up: a spin lasts long


def cuda_times(fn, reps: int) -> list[float]:
    """ms a call of ``fn`` in each of TIMING_ROUNDS rounds of ``reps``
    calls, timed by CUDA events after one warm-up call; sorted. Before
    each round the card spins (``torch.cuda._sleep``) for twice as long as
    the host takes to issue the round, so the events time the launches
    back to back and not the Python around them (a wrapper costs tens of
    microseconds, as much as a 0.03 ms kernel)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_cycles = int(min(2 * reps * issue_s, 0.1) * SPIN_CYCLES_PER_S)
    times = []
    for _ in range(TIMING_ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)


def cuda_ms(fn, reps: int) -> float:
    """The median of :func:`cuda_times`."""
    return cuda_times(fn, reps)[TIMING_ROUNDS // 2]


def host_ms(fn, reps: int) -> float:
    """ms a call of ``fn`` with the host's time to issue it: ``reps``
    calls back to back on the host's clock, from a synchronized card to a
    synchronized card. Where a kernel is shorter than its wrapper's
    Python, this is what a call costs on the path."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def spread(times: list[float]) -> str:
    return (f"median {times[TIMING_ROUNDS // 2]:.4f} ms (rounds "
            f"{times[0]:.4f}-{times[-1]:.4f})")


GRAD_CONTROLS = {
    "f32 deltas (no bf16 rounding)": {"_round_delta": lambda d: d.float()},
    "no density path into the trunk": {
        "_sigma_into_trunk": lambda d_sigma, w_alpha: 0.0},
}


def control_bwd(patches: dict, *args):
    """The plain backward with ``patches`` applied to ops/mlp_train.py:
    (its gradients, its planes)."""
    from nerf_replication_tpu_torch.ops import mlp_train

    keep = {}
    with contextlib.ExitStack() as stack:
        for name, fn in patches.items():
            stack.enter_context(mock.patch.object(mlp_train, name, fn))
        grads = mlp_train.fused_nerf_mlp_bwd_reference(*args, keep=keep)
    return grads, keep["planes"]


def _leaf_rel(k: torch.Tensor, p: torch.Tensor) -> float:
    return float((k - p).norm() / p.norm().clamp_min(1e-30))


def _leaves(flat_w, flat_b, packed):
    """(name, weight-or-bias leaf) pairs of the two packs, 2-D weights."""
    from nerf_replication_tpu_torch.ops import mlp_train

    shapes, _, sizes, _ = mlp_train._unpack(packed)
    at = 0
    for name, rows, cols in shapes:
        yield f"w{name}", flat_w[at:at + rows * cols].view(rows, cols)
        at += rows * cols
    at = 0
    for name, size in sizes:
        yield f"b{name}", flat_b[at:at + size][:, None]
        at += size


def _delta_planes(planes: dict) -> dict:
    out = {f"d{i}": d for i, d in enumerate(planes["d"])}
    out.update({k: planes[k] for k in ("d_af", "d_gpre", "d_rgb")})
    return out


def backward_agreement(out, ref, planes, ref_planes, packed, in_dim: int,
                       view_dim: int, x=None, v=None,
                       delta_diff: float = DELTA_DIFF) -> dict:
    """The backward check of ``out`` (weight-pack grad, bias-pack grad) and
    its delta ``planes`` against the plain ``ref`` and ``ref_planes``; with
    the features ``x``, ``v`` (a kernel's output) also the weight-gradient
    products against float64 sums of ``planes``. ``ok`` when every part
    holds, at most ``delta_diff`` of the deltas differing; the worst plane
    or leaf of each statistic."""
    from nerf_replication_tpu_torch.ops import mlp_train

    pad_rows = {"w0": in_dim, f"w{packed.skip + 1}x": in_dim, "wvd": view_dim}
    pad_cols = {"wrgb": 3, "balpha": 1, "brgb": 3}
    rel, pad_zero = {}, True
    for (name, k), (_, p) in zip(_leaves(*out, packed), _leaves(*ref, packed)):
        if name.startswith("b"):   # a bias: its padding is its tail
            r, c = pad_cols.get(name, k.shape[0]), 1
        else:
            r, c = pad_rows.get(name, k.shape[0]), pad_cols.get(name,
                                                                k.shape[1])
        pad_zero &= not bool(k[r:].any()) and not bool(k[:, c:].any())
        rel[name] = _leaf_rel(k[:r, :c], p[:r, :c])
    diff = {}
    ref_d = _delta_planes(ref_planes)
    for name, d in _delta_planes(planes).items():
        diff[name] = float((d.float() != ref_d[name].float()).float().mean())
    wgrad = {}
    if x is not None:
        f64 = {k: ([t.double() for t in p] if isinstance(p, list)
                   else p.double()) for k, p in planes.items()}
        sums = mlp_train.weight_grads(f64, x.double(), v.double(), packed)
        zeros = torch.zeros_like(out[1])
        for (name, k), (_, p) in zip(_leaves(out[0], zeros, packed),
                                     _leaves(sums.float(), zeros, packed)):
            if name.startswith("w"):
                wgrad[name] = _leaf_rel(k, p)
    finite = bool(torch.isfinite(out[0]).all() and torch.isfinite(out[1]).all())
    worst = lambda d: max(d, key=d.get) if d else "-"  # noqa: E731
    a = dict(rel=max(rel.values()), rel_leaf=worst(rel),
             diff=max(diff.values()), diff_plane=worst(diff),
             wgrad=max(wgrad.values()) if wgrad else 0.0,
             wgrad_leaf=worst(wgrad), pad_zero=pad_zero,
             max_abs_err=float(max((out[0] - ref[0]).abs().max(),
                                   (out[1] - ref[1]).abs().max())))
    a["ok"] = (finite and pad_zero and a["rel"] <= GRAD_REL
               and a["diff"] <= delta_diff
               and a["wgrad"] <= WGRAD_REL)
    return a


def describe_grad(a: dict) -> str:
    return (f"deltas: worst share differing {a['diff']:.2e} "
            f"({a['diff_plane']}, <= "
            f"{DELTA_DIFF}); weight-gradient sums vs f64 of the workspace "
            f"{a['wgrad']:.2e} ({a['wgrad_leaf']}, <= {WGRAD_REL}); leaves: "
            f"worst rel-norm err {a['rel']:.2e} ({a['rel_leaf']}, <= "
            f"{GRAD_REL}), padding exactly zero {a['pad_zero']}, max_abs_err "
            f"{a['max_abs_err']:.3e} {'ok' if a['ok'] else 'FAIL'}")


def ray_points(n: int, gen: torch.Generator):
    """Points and unit directions along rays from a radius-4 camera
    sphere at depths 2..6, as the render path makes them."""
    kw = dict(device="cuda", generator=gen)
    eye = torch.nn.functional.normalize(torch.randn(n, 3, **kw), dim=-1) * 4.0
    d = torch.nn.functional.normalize(
        -eye / 4.0 + 0.3 * torch.randn(n, 3, **kw), dim=-1)
    t = 2.0 + 4.0 * torch.rand(n, 1, **kw)
    return (eye + t * d).contiguous(), d.contiguous()


def _counters():
    """The ``tracing.counts`` keys of every wrapper's launches and every
    plain version's and nn.Module's calls, by reading."""
    plain = ("fused_nerf_mlp_enc_reference", "fused_nerf_mlp_reference",
             "fused_nerf_mlp_bwd_reference", "brick_encode_eval_reference",
             "brick_encode_cells_reference", "fused_ngp_eval_reference",
             "brick_encode_reference", "brick_encode_bwd_reference")
    return {
        "brick_fwd": ["brick_hash_encode.launches"],
        "brick_bwd": ["brick_hash_encode_bwd.launches"],
        "enc": ["fused_nerf_mlp_enc.launches"],
        "fwd": ["fused_nerf_mlp.launches"],
        "bwd": ["fused_nerf_mlp_bwd.launches"],
        "ngp_enc": ["brick_encode_eval.launches"],
        "ngp": ["fused_ngp_eval.launches"],
        "ngp_bf16": ["fused_ngp_eval.bf16_launches"],
        "plain": [f"{name}.calls" for name in plain],
        "module": ["Network.calls"],
        "mlp": ["NeRFMLP.calls"],
        "xla_encode": ["hash_encode.calls"],
    }


def reset_counts():
    """Every wrapper's launch count and every plain version's call count."""
    from nerf_replication_tpu_torch.utils import tracing

    for keys in _counters().values():
        for key in keys:
            tracing.counts.pop(key, None)


def read_counts() -> dict:
    """Launches of each kernel; calls of the plain versions (summed), of
    ``Network.forward`` (module), of ``NeRFMLP.forward`` (mlp) and of the
    xla hash grid's encode (xla_encode, plain PyTorch: no kernel)."""
    from nerf_replication_tpu_torch.utils import tracing

    return {name: sum(tracing.counts[key] for key in keys)
            for name, keys in _counters().items()}


def real_batch(cfg, net, arrays) -> dict:
    """One 1024-ray batch of the hard scene through the fused train path
    with ``net``'s weights: per branch, the kernels' inputs x, v and the
    batch's real dloss/draw."""
    from nerf_replication_tpu_torch.ops import mlp_kernel
    from nerf_replication_tpu_torch.train import make_trainer
    from nerf_replication_tpu_torch.train.cli import make_pipeline

    wrapper = make_trainer(cfg, net).wrapper
    fused = wrapper.renderer.train_apply
    seen = {}

    def capture(pts, viewdirs, model=""):
        raw = fused(pts, viewdirs, model)
        raw.retain_grad()
        seen[model or "coarse"] = (pts, viewdirs, raw)
        return raw

    wrapper.renderer._train_apply = capture
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = make_pipeline(cfg, arrays, "cuda").sample(gen, 1 << 30)
    loss, _ = wrapper.loss_fn(batch, gen, train=True)
    loss.backward()
    out = {}
    for branch, (pts, viewdirs, raw) in seen.items():
        p = pts.reshape(-1, 3).float()
        d = viewdirs.expand(*pts.shape[:-1], 3).reshape(-1, 3).float()
        x, v = mlp_kernel.encode_features(p, d, net.xyz_encoder.n_freqs,
                                          net.dir_encoder.n_freqs)
        out[branch] = (x, v, raw.grad.reshape(-1, 4).contiguous())
    return out


def phase_train_kernels(cfg, arrays) -> dict:
    """Phase 4: the features-in forward and the backward against their
    plain versions at the training shapes; returns errors and times."""
    from nerf_replication_tpu_torch.ops import mlp_kernel, mlp_train
    from nerf_replication_tpu_torch.run import load_model

    net = load_model(cfg, torch.device("cuda"))
    enc = net.xyz_encoder.output_dim, net.dir_encoder.output_dim
    res = {"fwd": [], "bwd": []}
    for branch, (x, v, g) in real_batch(cfg, net, arrays).items():
        mlp = getattr(net, branch)
        packed = mlp_kernel.pack_nerf_params(mlp.state_dict(), *enc,
                                             mlp.depth, mlp.skips[0])
        n = x.shape[0]
        out_k = mlp_kernel.fused_nerf_mlp(packed, x, v)
        out_p = mlp_kernel.fused_nerf_mlp_reference(packed, x, v)
        keep_k, keep_p = {}, {}
        grad_k = mlp_train.fused_nerf_mlp_bwd(packed, x, v, g, keep_k)
        grad_p = mlp_train.fused_nerf_mlp_bwd_reference(packed, x, v, g,
                                                        keep_p)
        torch.cuda.synchronize()
        a = agreement(out_k, out_p)
        b = backward_agreement(grad_k, grad_p, keep_k["planes"],
                               keep_p["planes"], packed, *enc, x=x, v=v)
        times = {
            "fwd": (cuda_ms(lambda: mlp_kernel.fused_nerf_mlp(packed, x, v), 20),
                    cuda_ms(lambda: mlp_kernel.fused_nerf_mlp_reference(
                        packed, x, v), 1)),
            "bwd": (cuda_ms(lambda: mlp_train.fused_nerf_mlp_bwd(
                        packed, x, v, g), 20),
                    cuda_ms(lambda: mlp_train.fused_nerf_mlp_bwd_reference(
                        packed, x, v, g), 1))}
        # the backward recomputes the forward, then forms the weight
        # gradients (a forward's products) and the deltas (a forward's
        # products less those of the input rows: no input gradients)
        flops = n * mlp_flops(mlp)
        bwd_flops = 3 * flops - n * input_side_flops(mlp, *enc)
        bounds = {"fwd": bound(nbytes(x, v, packed.w, packed.b, out_k),
                               flops, "bf16"),
                  "bwd": bound(nbytes(x, v, g, packed.w, packed.b, *grad_k),
                               bwd_flops, "bf16")}
        # the same 20 calls when the first must cudaMalloc its workspace
        # (about 10 KB a point), as the first step of a run does
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        cold_ms = cuda_ms(lambda: mlp_train.fused_nerf_mlp_bwd(
            packed, x, v, g), 20)
        for kind, check in (("fwd", a), ("bwd", b)):
            ms_k, ms_p = times[kind]
            res[kind].append(dict(n=n, err=check["max_abs_err"], ms=ms_k,
                                  plain_ms=ms_p, **bounds[kind]))
        print(f"features-in forward vs plain, {branch} N={n}: {describe(a)} "
              f"| kernel {times['fwd'][0]:.3f} ms, plain "
              f"{times['fwd'][1]:.3f} ms | "
              f"{against_first('fwd', n, res['fwd'][-1])}")
        print(f"backward vs plain, {branch} N={n}: {describe_grad(b)} | "
              f"kernel {times['bwd'][0]:.3f} ms ({cold_ms:.3f} ms with the "
              f"allocator's cache emptied first), plain "
              f"{times['bwd'][1]:.3f} ms"
              f" | {against_first('bwd', n, res['bwd'][-1])}")
        if not a["ok"]:
            fail(f"features-in forward disagrees with plain at N={n}")
        if not b["ok"]:
            fail(f"backward disagrees with plain at N={n}")
        del keep_k, grad_k
        for label, patches in GRAD_CONTROLS.items():
            grad_c, planes_c = control_bwd(patches, packed, x, v, g)
            c = backward_agreement(grad_c, grad_p, planes_c,
                                   keep_p["planes"], packed, *enc)
            print(f"control, plain backward with {label}, {branch} N={n}: "
                  f"{describe_grad(c)}")
            if c["ok"]:
                fail(f"the backward check accepts the plain backward with "
                     f"{label}, so it cannot see such a fault")
    del net
    torch.cuda.empty_cache()
    return res


# device-kernel name fragments -> the part of a step or frame they are
PROFILE_PARTS = (
    ("encode+MLP kernel", ("fused_nerf_mlp_enc_kernel",)),
    ("MLP forward kernel", ("fused_nerf_mlp_kernel",)),
    ("backward recompute + deltas", ("nerf_mlp_bwd_delta",)),
    ("weight-gradient products", ("nerf_mlp_bwd_wgrad",)),
    ("weight-gradient reduction", ("reduce_rows_kernel",)),
    ("fused NGP encode+MLP kernel", ("fused_ngp_kernel",)),
    ("brick encode kernel", ("brick_encode_eval_kernel",)),
    ("brick training forward", ("brick_hash_encode_fwd_kernel",)),
    ("brick table gradient", ("brick_hash_encode_bwd_kernel",)),
    ("memset", ("Memset",)),
    ("GEMMs (cuBLAS/CUTLASS)", ("gemm", "cutlass", "xmma", "sm90_")),
    ("sort", ("sort", "Sort")),
    ("scans (cumsum/cumprod)", ("scan", "Scan", "cumsum", "cumprod")),
    ("optimizer", ("multi_tensor_apply",)),
)


def profile_runs(run, count: int, unit: str, tag: str, warm: int = 3):
    """The device busy ms a call of :func:`profile_reading`."""
    return profile_reading(run, count, unit, tag, warm)["busy_ms"]


def profile_reading(run, count: int, unit: str, tag: str,
                    warm: int = 3) -> dict:
    """``count`` calls of ``run`` (after ``warm`` to warm up) under
    torch.profiler: the device time a call by part (PROFILE_PARTS, the rest
    as "other") and the idle share of the wall time; the full table goes to
    build/profile_<tag>.txt. Returns the device busy ms and the wall ms a
    call, and the idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(count):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    parts = {}
    for e in kernels:
        part = next((name for name, keys in PROFILE_PARTS
                     if any(k in e.key for k in keys)), "other")
        parts[part] = parts.get(part, 0.0) + e.self_device_time_total
    busy = sum(parts.values()) / 1e6
    summary = (f"profile {tag}: {count} {unit}s under the profiler, wall "
               f"{wall * 1e3 / count:.2f} ms a {unit}, device busy "
               f"{busy * 1e3 / count:.2f} ms a {unit} (idle "
               f"{100 * (1 - busy / wall):.1f}%); device ms a {unit}: "
               + "; ".join(f"{name} {t / 1e3 / count:.3f}" for name, t in
                           sorted(parts.items(), key=lambda kv: -kv[1])))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", f"profile_{tag}.txt"), "w") as f:
        f.write(summary + "\n\n")
        f.write(events.table(sort_by="self_device_time_total", row_limit=60))
    print(summary)
    return {"busy_ms": busy * 1e3 / count, "wall_ms": wall * 1e3 / count,
            "idle": 1 - busy / wall}


def profile_steps(trainer, pipeline, steps: int, tag: str):
    """``steps`` more training steps under the profiler."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    profile_runs(lambda: trainer.train_step(
        pipeline.sample(gen, trainer.step), gen), steps, "step", tag)


def checkpoint_round_trip(arm: dict, view) -> bool:
    """Save ``arm``'s network and optimizer with save_model, load the
    weights back through load_network into a new network and render
    ``view``: True when the image is the one the arm rendered."""
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.run import build_renderer
    from nerf_replication_tpu_torch.utils.ckpt_utils import (
        load_network,
        params_from_jax,
        save_model,
    )

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    save_model(arm["net"], arm["trainer"].optimizer.state_dict(),
               {"step": arm["steps"]}, {"step": arm["steps"], "epoch": 3}, 3,
               CKPT_DIR)
    net = make_network(arm["cfg"])
    net.load_state_dict(params_from_jax(load_network(CKPT_DIR)))
    again = build_renderer(arm["cfg"], net.cuda()).render(view)[0]
    same = bool(np.array_equal(again.cpu().numpy(), arm["images"][0]))
    print(f"checkpoint round trip: {CKPT_DIR} loaded by load_network renders "
          f"view 0 {'identically' if same else 'DIFFERENTLY'}")
    return same


def train_arm(fused: bool, arrays, views, steps: int, profile: int) -> dict:
    """Train one arm from the fresh seed-0 init; returns its readings (and,
    for the kernel arm, whether its checkpoint round trip held)."""
    from nerf_replication_tpu_torch.config import make_cfg, parse_args
    from nerf_replication_tpu_torch.evaluators import psnr_uint8
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.run import build_renderer
    from nerf_replication_tpu_torch.train import make_trainer
    from nerf_replication_tpu_torch.train.cli import make_pipeline

    cfg = make_cfg(parse_args(TRAIN_ARGV + [
        "network.use_pallas_mlp_train", str(fused),
        "ep_iter", str(steps // 4)]))
    net = make_network(cfg).cuda()
    trainer = make_trainer(cfg, net)
    trainer.wrapper.renderer.train_apply   # builds the kernels now
    pipeline = make_pipeline(cfg, arrays, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def evaluate():
        renderer = build_renderer(cfg, net)   # packs the current weights
        images = [renderer.render(view)[0].cpu().numpy() for view in views]
        return images, float(np.mean([psnr_uint8(img, view["colors"])
                                      for img, view in zip(images, views)]))

    reset_counts()
    summaries = [trainer.train_device(e, pipeline) for e in range(3)]
    counts = read_counts()
    _, psnr_prev = evaluate()
    reset_counts()
    summaries.append(trainer.train_device(3, pipeline))
    counts = {k: counts[k] + n for k, n in read_counts().items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = np.concatenate([s["loss"] for s in summaries])
    psnrs = np.concatenate([s["psnr"] for s in summaries])
    images, eval_psnr = evaluate()
    arm = dict(cfg=cfg, net=net, trainer=trainer, counts=counts,
               steps=trainer.step, losses=losses, images=images,
               eval_psnr=eval_psnr, eval_mean=(psnr_prev + eval_psnr) / 2,
               peak_gb=peak_gb,
               rays_per_s=[s["rays_per_s"] for s in summaries],
               loss=float(np.median(losses[-20:])),
               psnr=float(np.median(psnrs[-20:])))
    label = "kernels" if fused else "nn.Module"
    print(f"train ({label}): {arm['steps']} steps, rays/s per epoch "
          f"{[round(r) for r in arm['rays_per_s']]}, final smoothed loss "
          f"{arm['loss']:.5f}, train PSNR {arm['psnr']:.2f} dB, peak memory "
          f"{peak_gb:.2f} GB, eval PSNR (hard test views 0, 4, 800x800) "
          f"{eval_psnr:.4f} dB after {arm['steps']} steps, {psnr_prev:.4f} "
          f"dB after {3 * steps // 4}, counts in training {counts}")
    if fused:
        arm["round_trip"] = checkpoint_round_trip(arm, views[0])
    if profile:
        profile_steps(trainer, pipeline, profile, label.replace(".", ""))
    return arm


def phase_train(arrays, views, steps: int, profile: int) -> dict:
    """Phase 5: the two arms and the checkpoint round trip."""
    k = train_arm(True, arrays, views, steps, profile)
    c = k["counts"]
    if (c["fwd"], c["bwd"], c["plain"], c["module"], c["enc"]) != \
            (2 * steps, 2 * steps, 0, 0, 0):
        fail(f"the kernel arm did not train through the kernels alone: {c}")
    del k["net"], k["trainer"]
    torch.cuda.empty_cache()

    m = train_arm(False, arrays, views, steps, profile)
    c = m["counts"]
    if c["fwd"] or c["bwd"] or c["enc"] or c["plain"] \
            or c["module"] != 2 * steps:
        fail(f"the nn.Module arm did not train through the nn.Module: {c}")
    for arm in (k, m):
        if not np.isfinite(arm["losses"]).all():
            fail("a training loss is not finite")
        if arm["eval_psnr"] < TRAIN_PSNR_FLOOR_DB:
            fail(f"eval PSNR {arm['eval_psnr']:.4f} dB below the floor "
                 f"{TRAIN_PSNR_FLOOR_DB} dB")
    diff = abs(k["eval_mean"] - m["eval_mean"])
    print(f"arms: eval PSNR at the last step kernels {k['eval_psnr']:.4f} "
          f"dB, nn.Module {m['eval_psnr']:.4f} dB; mean of the last two "
          f"epochs' ends kernels {k['eval_mean']:.4f} dB, nn.Module "
          f"{m['eval_mean']:.4f} dB, difference {diff:.4f} dB (<= "
          f"{ARMS_MAX_DIFF_DB}); train rays/s (epochs 1-3) kernels "
          f"{np.mean(k['rays_per_s'][1:]):,.0f}, nn.Module "
          f"{np.mean(m['rays_per_s'][1:]):,.0f}")
    if diff > ARMS_MAX_DIFF_DB:
        fail(f"the arms' eval PSNRs differ by {diff:.4f} dB")
    if not k["round_trip"]:
        fail("the saved checkpoint does not render what the network did")
    return k["counts"]


def ngp_chunk_samples(cfg, net, view) -> dict:
    """The samples of ray chunk NGP_CHUNK of ``view`` as the fused route
    evaluates them: branch -> (pts (rays, samples, 3), viewdirs (rays, 1,
    3))."""
    from nerf_replication_tpu_torch.models.nerf.renderer import RenderSettings
    from nerf_replication_tpu_torch.run import build_renderer

    renderer = build_renderer(cfg, net)
    fused = renderer.apply_fn
    seen = {}

    def capture(pts, viewdirs, model=""):
        seen[model or "coarse"] = (pts.clone(), viewdirs.clone())
        return fused(pts, viewdirs, model)

    renderer.use_apply(capture)
    size = RenderSettings.from_cfg(cfg).ray_chunk
    rays = slice(NGP_CHUNK * size, (NGP_CHUNK + 1) * size)
    renderer.render_rays_batch(view["rays_o"][rays], view["rays_d"][rays])
    return seen


def _table_in_f32(enc, x, plain):
    """The plain encode with the table read in f32: the training forward's
    plain version with every level above its bf16 threshold."""
    from nerf_replication_tpu_torch.ops import hashgrid_kernel

    with mock.patch.object(hashgrid_kernel, "MXU_MAX_ROWS", 0):
        return hashgrid_kernel.brick_encode_reference(
            enc.layout, enc.table.detach(), x)


def _mlp_in_bf16(enc, x, plain):
    """``plain`` (the plain fused version) with its MLP products in bf16."""
    from nerf_replication_tpu_torch.ops import fused_ngp

    bf16 = lambda a, b: (a.bfloat16() @ b.bfloat16()).float()  # noqa: E731
    with mock.patch.object(fused_ngp, "_matmul", bf16):
        return plain()


def _mlp_in_tf32(enc, x, plain):
    """``plain`` with its MLP products in TF32 (on a card only)."""
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return plain()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep


def _bf16_arm_in_f32(enc, x, plain):
    """``plain`` (the bf16 arm's plain version) with no bf16 rounding of
    operands or biases: the f32 arm's plain version."""
    from nerf_replication_tpu_torch.ops import fused_ngp

    with mock.patch.object(fused_ngp, "_round_bf16", lambda t: t):
        return plain()


# phase 6's controls: label -> (the kernel whose check must reject it, the
# control's output from (encoder, points, that kernel's plain version))
NGP_CONTROLS = {
    "table read in f32 (no bf16 rounding)": ("encode", _table_in_f32),
    "MLP in bf16": ("fused", _mlp_in_bf16),
    "MLP in TF32": ("fused", _mlp_in_tf32),
    "the f32 arm (no bf16 operands)": ("fused_bf16", _bf16_arm_in_f32),
}


def ngp_runs(layout, packed, ops, meta, x, sh, cells=None):
    """Phase 6's kernels on one set of points: name -> (kernel, plain,
    bytes each input read once and the output written once, operations by
    type, the check's bounds), and the f32 operations of the whole field.
    The fused f32 arm's operations are its 3xTF32 products (three TF32
    products a multiply-add) beside the encode's f32 ones; the f32
    operations give its CUDA-core bound too. The encode is run only where
    ``cells``, the cell-corner table of ``packed``, is given; its bytes are
    counted from the packed table, the function's own input, as they were
    for its first design."""
    from nerf_replication_tpu_torch.ops import (
        eval_encode,
        fused_ngp,
        hashgrid_kernel,
    )

    n = x.shape[0]
    enc_ops = n * hashgrid_kernel.encode_flops_per_point(layout)
    mlp_ops = n * fused_ngp.mlp_flops_per_point(ops)
    io = nbytes(x, packed) + 16 * n       # the (N, 4) f32 output
    fused_io = io + nbytes(sh, ops.flat)
    runs = {
        "fused": (lambda: fused_ngp.fused_ngp_eval(layout, meta, packed, ops,
                                                   x, sh),
                  lambda: fused_ngp.fused_ngp_eval_reference(
                      layout, meta, packed, ops, x, sh),
                  fused_io, {"tf32": 3 * mlp_ops, "f32": enc_ops},
                  NGP_BOUNDS),
        "fused_bf16": (lambda: fused_ngp.fused_ngp_eval(
            layout, meta, packed, ops, x, sh, mlp_bf16=True),
            lambda: fused_ngp.fused_ngp_eval_reference(
                layout, meta, packed, ops, x, sh, mlp_bf16=True),
            fused_io, {"bf16": mlp_ops, "f32": enc_ops}, NGP_BF16_BOUNDS),
    }
    if cells is not None:
        runs["encode"] = (
            lambda: eval_encode.brick_encode_eval(layout, cells, x),
            lambda: eval_encode.brick_encode_cells_reference(layout, cells,
                                                             x),
            nbytes(x, packed) + 4 * n * 2 * len(layout.scales),
            {"f32": enc_ops}, NGP_BOUNDS)
    return runs, enc_ops + mlp_ops


def check_ngp_kernel(name, runs, f32_ops, tag, reps=20, oracle=None,
                     gathers=None, first=None) -> dict:
    """One of :func:`ngp_runs`' kernels against its plain version: the
    check, CUDA-event times and bounds (the fused f32 arm's both), printed;
    fails the run where they disagree. The encode must equal its plain
    version and ``oracle`` (the plain version from the packed table) bit
    for bit; beside its time are printed its time with the host's issue
    time, the first design's (``first``, from :func:`first_brick_design`)
    and its sector counts ``gathers`` (:func:`gather_sectors`). Returns the
    reading and the plain output."""
    kernel, plain, n_bytes, ops, bounds = runs[name]
    out_k, out_p = kernel(), plain()
    torch.cuda.synchronize()
    a = agreement(out_k, out_p, bounds)
    times = cuda_times(kernel, reps)
    ms_k, ms_p = times[TIMING_ROUNDS // 2], cuda_ms(plain, 1)
    b = bound(n_bytes, ops)
    equal = torch.equal(out_k, out_p)
    extra = ""
    if name == "fused":
        b32 = bound(n_bytes, f32_ops, "f32")
        extra = (f"; CUDA-core f32 bound {b32['bound_ms']:.4f} ms "
                 f"({b32['bound_ms'] / ms_k:.1%} of it reached)")
        b = dict(b, f32_bound_ms=b32["bound_ms"])
    if oracle is not None:
        equal = equal and torch.equal(out_k, oracle)
        extra += (f"; {spread(times)}, with the host's issue time "
                  f"{host_ms(kernel, reps):.4f} ms a call; {first[1]}"
                  f"{describe_sectors(gathers, ms_k, first[0])}")
    print(f"NGP {name} kernel vs plain, {tag}: {describe(a)}, bit-equal "
          f"{equal} | kernel {ms_k:.4f} ms (bound "
          f"{b['bound_ms']:.4f} ms by {b['bound_by']}, "
          f"{b['bound_ms'] / ms_k:.1%} of it reached{extra}; "
          f"{f32_ops / ms_k / 1e9:.1f} TFLOP/s of f32-equivalent work), "
          f"plain {ms_p:.3f} ms")
    if not a["ok"] or (oracle is not None and not equal):
        fail(f"NGP {name} kernel disagrees with its plain version, {tag}")
    return dict(n=out_k.shape[0], err=a["max_abs_err"], ms=ms_k,
                plain_ms=ms_p, **b), out_p


def ngp_kernels_against_plain(cfg, net, view) -> dict:
    """Phase 6 (a): each NGP kernel (the encode, the fused kernel's two
    arms) against its plain version on the samples of one real chunk, each
    branch on its own pass's points; the controls and the 3xTF32 emulation
    on the coarse points; then the fused f32 arm on a 16-level network.
    Returns, per kernel, its readings at each size."""
    from nerf_replication_tpu_torch.models.nerf.renderer import ngp_renderer
    from nerf_replication_tpu_torch.ops import eval_encode, fused_ngp

    enc = net.xyz_encoder
    layout = enc.layout
    packed = eval_encode.pack_eval_table(enc.table.detach())
    cells = eval_encode.pack_cell_table(packed)
    res = {"encode": [], "fused": [], "fused_bf16": []}
    for branch, (pts, viewdirs) in ngp_chunk_samples(cfg, net, view).items():
        mlp = getattr(net, branch)
        ops, meta = fused_ngp.extract_mlp_weights(
            mlp.state_dict(), enc.output_dim, mlp.depth, mlp.skips,
            mlp.view_depth)
        x, sh = ngp_renderer.fused_inputs(net, pts, viewdirs)
        runs, f32_ops = ngp_runs(layout, packed, ops, meta, x, sh, cells)
        tag = f"{branch} N={x.shape[0]}"
        oracle = eval_encode.brick_encode_eval_reference(layout, packed, x)
        for name in res:
            if name == "encode":
                reading, out_p = check_ngp_kernel(
                    name, runs, f32_ops, tag, oracle=oracle,
                    gathers=gather_sectors(layout, x, "packed", "cells"),
                    first=first_brick_design("encode", layout, packed, x,
                                             oracle))
            else:
                reading, out_p = check_ngp_kernel(name, runs, f32_ops, tag)
            res[name].append(reading)
            if branch != "coarse":
                continue
            for label, (target, control) in NGP_CONTROLS.items():
                if target == name:
                    c = agreement(control(enc, x, runs[name][1]), out_p,
                                  runs[name][4])
                    print(f"control, NGP {name} plain with {label}, {tag}: "
                          f"{describe(c)}")
                    if c["ok"]:
                        fail(f"the NGP check accepts the plain {name} with "
                             f"{label}, so it cannot see such a fault")
            if name == "fused":
                with mock.patch.object(fused_ngp, "_matmul",
                                       fused_ngp.matmul_3xtf32):
                    emu = runs["fused"][1]()
                print(f"NGP fused plain with 3xTF32 products (emulated), "
                      f"{tag}: {describe(agreement(emu, out_p, NGP_BOUNDS))}")
            del out_p
        last = (x, sh)
    ngp_16_levels(*last)
    return res


def ngp_16_levels(x, sh) -> None:
    """The fused f32 arm on a 16-level network (configs/nerf/lego_ngp.yaml:
    32 encoded features, W=64, degree-4 SH) with seeded random weights and a
    table drawn from U(-1, 1), on the points ``x`` and SH ``sh`` of a real
    chunk: against its plain version, with both bounds."""
    from nerf_replication_tpu_torch.config import make_cfg, parse_args
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.ops import eval_encode, fused_ngp

    torch.manual_seed(0)
    net = make_network(make_cfg(parse_args(list(NGP_16_LEVELS)))).cuda()
    enc = net.xyz_encoder
    gen = torch.Generator(device="cuda").manual_seed(0)
    packed = eval_encode.pack_eval_table(
        torch.empty_like(enc.table).uniform_(-1, 1, generator=gen))
    ops, meta = fused_ngp.extract_mlp_weights(
        net.fine.state_dict(), enc.output_dim, net.fine.depth,
        net.fine.skips, 1)
    runs, f32_ops = ngp_runs(enc.layout, packed, ops, meta, x, sh)
    check_ngp_kernel("fused", runs, f32_ops,
                     f"16 levels ({enc.output_dim} features, "
                     f"{enc.layout.n_rows} table rows, random) N={x.shape[0]}")
    del net


def phase_ngp(views, profile: bool) -> dict:
    """Phase 6: the NGP eval kernels against plain, then the fused,
    unfused and plain routes; with ``profile``, NGP_PROFILE_FRAMES fused
    frames of view 0 under the profiler. Returns the kernels' readings
    with their launches on their routes."""
    from nerf_replication_tpu_torch.config import make_cfg, parse_args
    from nerf_replication_tpu_torch.evaluators import psnr_uint8
    from nerf_replication_tpu_torch.models.nerf.renderer import (
        RenderSettings,
        make_renderer,
        ngp_renderer,
    )
    from nerf_replication_tpu_torch.run import (
        build_renderer,
        load_model,
        resolve_device,
        run_evaluate,
    )

    cfg = make_cfg(parse_args(NGP_ARGV))
    net = load_model(cfg, resolve_device(cfg))
    with torch.no_grad():
        res = ngp_kernels_against_plain(cfg, net, views[0])
    torch.cuda.empty_cache()

    # (b) the slice: the fused route, as `run --type evaluate` runs it
    H, W = int(views[0]["H"]), int(views[0]["W"])
    chunks = math.ceil(H * W / RenderSettings.from_cfg(cfg).ray_chunk)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    fused = run_evaluate(cfg, loader=views)
    counts = fused_counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for rgb in fused["rgb"]:
        if rgb.shape != (H * W, 3) or not np.isfinite(rgb).all():
            fail(f"NGP render output is not a finite ({H * W}, 3) image")
    print(f"NGP slice (fused): PSNR {fused['psnr']:.4f} dB, SSIM "
          f"{fused['ssim']:.4f} (JAX record {NGP_JAX_PSNR_DB} dB), frame "
          f"times {[round(t, 4) for t in fused['net_time']]} s, counts "
          f"{counts} (expected ngp {2 * chunks * len(views)}, every other 0), "
          f"peak memory {peak_gb:.2f} GB")
    expect = dict.fromkeys(counts, 0) | {"ngp": 2 * chunks * len(views)}
    if counts != expect:
        fail(f"the NGP slice did not run through the fused kernel alone: "
             f"{counts}")
    if abs(fused["psnr"] - NGP_JAX_PSNR_DB) > PSNR_BUDGET_DB:
        fail(f"NGP PSNR {fused['psnr']:.4f} dB is not within "
             f"{PSNR_BUDGET_DB} dB of {NGP_JAX_PSNR_DB} dB")
    renderer = build_renderer(cfg, net)
    device_ms = {"fused": profile_runs(lambda: renderer.render(views[0]), 1,
                                       "frame", "ngp_fused_frame", warm=1)}
    if profile:
        profile_runs(lambda: renderer.render(views[0]), NGP_PROFILE_FRAMES,
                     "frame", "ngp_fused")
    del renderer

    # (c) view 0 through the fused kernel's bf16 arm, the unfused route and
    # the plain route
    routes = {}
    for route, apply, nonzero in (
            ("bf16", ngp_renderer.make_ngp_eval_apply(net, mlp_bf16=True),
             {"ngp_bf16": 2 * chunks}),
            ("unfused", ngp_renderer.make_ngp_eval_apply(net, fused=False),
             {"ngp_enc": 2 * chunks, "mlp": 2 * chunks})):
        renderer = make_renderer(cfg, net).use_apply(apply)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rgb = renderer.render(views[0])[0]
        torch.cuda.synchronize()
        routes[route] = (rgb.cpu().numpy(), time.perf_counter() - t0,
                         read_counts(), nonzero)
        device_ms[route] = profile_runs(lambda: renderer.render(views[0]), 1,
                                        "frame", f"ngp_{route}_frame", warm=1)
        del renderer
    del net
    cfg_plain = make_cfg(parse_args(NGP_ARGV + ["network.use_pallas_mlp",
                                                "False"]))
    reset_counts()
    plain = run_evaluate(cfg_plain, loader=views[:1])
    routes["plain"] = (plain["rgb"][0], plain["net_time"][0], read_counts(),
                       {"module": 2 * chunks, "mlp": 2 * chunks,
                        "brick_fwd": 2 * chunks})
    print(f"NGP device busy ms a frame of view 0 (one profiled frame): "
          f"{ {k: round(v, 2) for k, v in device_ms.items()} }")
    for route, (image, seconds, counts, nonzero) in routes.items():
        vs_fused = psnr_uint8(image, fused["rgb"][0])
        floor = NGP_BF16_MIN_DB if route == "bf16" else NGP_ROUTES_MIN_DB
        print(f"NGP {route} route, view 0: PSNR vs the fused render "
              f"{vs_fused:.2f} dB (>= {floor}), vs GT "
              f"{psnr_uint8(image, views[0]['colors']):.4f} dB, frame "
              f"{seconds:.4f} s against {fused['net_time'][0]:.4f} s fused, "
              f"counts {counts}")
        if counts != dict.fromkeys(counts, 0) | nonzero:
            fail(f"the NGP {route} route did not run its own path: {counts}")
        if vs_fused < floor:
            fail(f"the NGP {route} render is {vs_fused:.2f} dB from the "
                 f"fused render")
    torch.cuda.empty_cache()
    res["launches"] = {"fused": fused_counts["ngp"],
                       "fused_bf16": routes["bf16"][2]["ngp_bf16"],
                       "encode": routes["unfused"][2]["ngp_enc"]}
    res["dense"] = fused
    return res


def _ngp_train_cfg(*opts):
    from nerf_replication_tpu_torch.config import make_cfg, parse_args

    return make_cfg(parse_args(NGP_TRAIN_ARGV + list(opts)))


def _bwd_f32_contributions(layout, x, g):
    """The plain backward summed in f64 with f32 contributions on every
    level: every level above its bf16 threshold."""
    from nerf_replication_tpu_torch.ops import hashgrid_kernel as hk

    with mock.patch.object(hk, "MXU_MAX_ROWS", 0):
        return hk.brick_encode_bwd_reference(layout, x, g, torch.float64)


def _bwd_truncated_bf16(layout, x, g):
    """The plain backward summed in f64 with the contributions' bf16
    rounding replaced by truncation."""
    from nerf_replication_tpu_torch.ops import hashgrid_kernel as hk

    with mock.patch.object(hk, "_round_bf16", _truncate_bf16):
        return hk.brick_encode_bwd_reference(layout, x, g, torch.float64)


BRICK_BWD_CONTROLS = {
    "f32 contributions on the bf16 levels": _bwd_f32_contributions,
    "contributions truncated to bf16": _bwd_truncated_bf16,
}


def brick_bwd_agreement(layout, dtable, ref64, live) -> dict:
    """The table-gradient check of ``dtable`` against the order-free f64
    sums ``ref64``: per level the largest error over its max |gradient|;
    ``ok`` when every level is within BRICK_BWD_TOL, all is finite and the
    padding (not ``live``) is exactly zero."""
    err = (dtable.double() - ref64).abs()
    levels = []
    for level in range(len(layout.scales)):
        rows = slice(layout.offsets[level], layout.offsets[level + 1])
        levels.append(float(err[rows].max()
                            / ref64[rows].abs().max().clamp_min(1e-300)))
    pad_zero = not bool(dtable[~live].any())
    ok = (bool(torch.isfinite(dtable).all()) and pad_zero
          and max(levels) <= BRICK_BWD_TOL)
    return dict(ok=ok, levels=levels, worst=max(levels), pad_zero=pad_zero,
                max_abs_err=float(err.max()))


def describe_brick_bwd(a: dict) -> str:
    return (f"worst level err / level max |gradient| {a['worst']:.2e} (level "
            f"{a['levels'].index(a['worst'])}, <= {BRICK_BWD_TOL}), padding "
            f"exactly zero {a['pad_zero']}, max_abs_err "
            f"{a['max_abs_err']:.3e} {'ok' if a['ok'] else 'FAIL'}")


def brick_real_batch(log2_bricks: int, arrays):
    """A hard_ngp network of that brick cap, NGP_WARM_STEPS training steps
    from its seed-0 init, and what its encoder sees on one more real
    batch (:func:`encoder_real_batch`)."""
    cfg = _ngp_train_cfg("network.xyz_encoder.log2_bricks", str(log2_bricks),
                         "ep_iter", str(NGP_WARM_STEPS))
    return encoder_real_batch(cfg, arrays, warm=True)


def encoder_real_batch(cfg, arrays, warm: bool):
    """The config's network from its seed-0 init, after one epoch of
    ``ep_iter`` training steps when ``warm``, and what its encoder sees on
    one more real batch: [(x, g) of the coarse pass, (x, g) of the fine
    pass], x in [0,1]^3 and g the loss's gradient with respect to the
    encoder's output."""
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.train import make_trainer
    from nerf_replication_tpu_torch.train.cli import make_pipeline

    net = make_network(cfg).cuda()
    trainer = make_trainer(cfg, net)
    pipeline = make_pipeline(cfg, arrays, "cuda")
    if warm:
        trainer.train_device(0, pipeline)
    seen = []

    def capture(encoder, inputs, output):
        x = encoder.to_unit(inputs[0].detach().reshape(-1, 3).float())
        output.register_hook(lambda g: seen.append(
            (x.contiguous(), g.reshape(-1, encoder.output_dim))))

    gen = torch.Generator(device="cuda").manual_seed(1)
    hook = net.xyz_encoder.register_forward_hook(capture)
    loss, _ = trainer.wrapper.loss_fn(pipeline.sample(gen, trainer.step), gen,
                                      train=True)
    loss.backward()
    hook.remove()
    net.zero_grad(set_to_none=True)
    return net, sorted(seen, key=lambda xg: xg[0].shape[0])


def merged_share(layout, x) -> tuple:
    """What the table gradient's warp merge makes of its (address, value)
    pairs: a warp takes 32 consecutive points at one level and merges, for
    each pair of corners c, c + 1 (dz = 0, 1), the lanes whose cells
    coincide. Returns the share of pairs folded into another lane's add,
    and the atomic operations issued over the pairs (a float2 add for both
    corners of a feature where corner c's index is even, else two)."""
    from nerf_replication_tpu_torch.ops import hashgrid_kernel as hk

    n = x.shape[0]
    warp = torch.arange(n, device=x.device) // 32
    kept = ops = total = 0
    zeros = torch.zeros(n, 2 * len(layout.scales), device=x.device)
    for k, (index, _) in enumerate(hk._corner_updates(layout, x, zeros)):
        total += n
        if k % 4 == 0:    # feature 0 of corner c, dz = 0 (c + 1, feature 1
            keys = torch.unique(warp * 2 ** 32 + index)      # merge alike)
            kept += 4 * keys.numel()
            ops += int((2 + 2 * (keys % 2)).sum())
    return 1.0 - kept / total, ops / total


def brick_kernels_against_plain(log2_bricks: int, arrays) -> dict:
    """Phase 7 (a) at one brick cap: the training forward and the table
    gradient against their plain versions on a real batch; returns, per
    kernel, its readings at the coarse and the fine size."""
    from nerf_replication_tpu_torch.ops import hashgrid_kernel as hk

    net, batches = brick_real_batch(log2_bricks, arrays)
    enc = net.xyz_encoder
    layout, table = enc.layout, enc.table.detach()
    live = hk.live_entries(layout).cuda()
    rows = [hk.level_rows(layout, level)
            for level in range(len(layout.scales))]
    print(f"brick layout log2_bricks {log2_bricks}: {layout.n_rows} rows, "
          f"levels of {rows} rows, {sum(r > hk.MXU_MAX_ROWS for r in rows)} "
          f"of them f32; table max |value| {float(table.abs().max()):.3f} "
          f"after {NGP_WARM_STEPS} steps")
    res = {"fwd": [], "bwd": []}
    for x, g in batches:
        n = x.shape[0]
        tag = f"b{log2_bricks} N={n}"
        out_k = hk.brick_hash_encode(layout, table, x)
        out_p = hk.brick_encode_reference(layout, table, x)
        out_c = _table_in_f32(enc, x, None)
        d_k = hk.brick_hash_encode_bwd(layout, x, g)
        d_64 = hk.brick_encode_bwd_reference(layout, x, g, torch.float64)
        torch.cuda.synchronize()
        fwd_err = float((out_k - out_p).abs().max())
        equal = torch.equal(out_k, out_p)
        a = brick_bwd_agreement(layout, d_k, d_64, live)
        touched = hk.touched_entries(layout, x)
        flops = n * hk.encode_flops_per_point(layout)
        fwd_times = cuda_times(lambda: hk.brick_hash_encode(layout, table, x),
                               20)
        ms = {"fwd": (fwd_times[TIMING_ROUNDS // 2],
                      cuda_ms(lambda: hk.brick_encode_reference(layout, table,
                                                                x), 1)),
              "bwd": (cuda_ms(lambda: hk.brick_hash_encode_bwd(layout, x, g),
                              20),
                      cuda_ms(lambda: hk.brick_encode_bwd_reference(
                          layout, x, g), 1))}
        # each input once, each output once: the points, the touched table
        # entries and the features; for the gradient also g, and the whole
        # dtable zeroed before the touched entries are written
        bounds = {"fwd": bound(nbytes(x, out_k) + 4 * touched, flops, "f32"),
                  "bwd": bound(nbytes(x, g, d_k) + 4 * touched, flops, "f32")}
        index, value = (torch.cat(t) for t in zip(*hk._corner_updates(
            layout, x, g.float())))
        flat = torch.zeros(layout.n_rows * hk.ROW, device="cuda")
        scatter_ms = cuda_ms(lambda: flat.index_add_(0, index, value), 5)
        del index, value, flat
        merged, ops = merged_share(layout, x)
        gathers = gather_sectors(layout, x, "train", "train")
        issue = host_ms(lambda: hk.brick_hash_encode(layout, table, x), 20)
        # the first design's readings are of the config's layout
        first_ms, first = (
            first_brick_design("brick_fwd", layout, table, x, out_p)
            if log2_bricks == NGP_LAYOUTS[0] or FIRST_DESIGNS else (None, ""))
        print(f"brick training forward vs plain, {tag}: bit-equal {equal}, "
              f"max_abs_err {fwd_err:.3e}; plain with the table read in f32 "
              f"differs by {float((out_c - out_p).abs().max()):.3e} | kernel "
              f"{spread(fwd_times)} (bound {bounds['fwd']['bound_ms']:.4f} "
              f"ms by {bounds['fwd']['bound_by']}, "
              f"{bounds['fwd']['bound_ms'] / ms['fwd'][0]:.1%} of it "
              f"reached), with the host's issue time {issue:.4f} ms a call, "
              f"plain {ms['fwd'][1]:.3f} ms; {touched} table entries "
              f"touched; {first}"
              + describe_sectors(gathers, ms["fwd"][0], first_ms))
        print(f"brick table gradient vs plain summed in f64, {tag} (g "
              f"contiguous {g.is_contiguous()}): {describe_brick_bwd(a)} | "
              f"kernel {ms['bwd'][0]:.4f} ms (bound "
              f"{bounds['bwd']['bound_ms']:.4f} ms by "
              f"{bounds['bwd']['bound_by']}), plain {ms['bwd'][1]:.3f} ms; "
              f"one index_add_ over the same {16 * len(rows) * n} pairs "
              f"{scatter_ms:.3f} ms; the warp merge folds {merged:.1%} of "
              f"them into another lane's add, and the kernel issues "
              f"{ops:.1%} as many atomic operations (float2 pairs)")
        if not equal or not bool(torch.isfinite(out_k).all()):
            fail(f"the brick training forward differs from plain, {tag}")
        if torch.equal(out_c, out_p):
            fail("the forward check cannot see a table read in f32")
        if not a["ok"]:
            fail(f"the brick table gradient disagrees with plain, {tag}")
        for label, control in BRICK_BWD_CONTROLS.items():
            c = brick_bwd_agreement(layout, control(layout, x, g), d_64, live)
            print(f"control, plain backward with {label}, {tag}: "
                  f"{describe_brick_bwd(c)}")
            if c["ok"]:
                fail(f"the table-gradient check accepts the plain backward "
                     f"with {label}, so it cannot see such a fault")
        for kind, err in (("fwd", fwd_err), ("bwd", a["max_abs_err"])):
            res[kind].append(dict(n=n, err=err, ms=ms[kind][0],
                                  plain_ms=ms[kind][1], **bounds[kind]))
        res["bwd"][-1]["library_ms"] = scatter_ms
    del net
    torch.cuda.empty_cache()
    return res


def ngp_checkpoint_round_trip(arm: dict, view) -> bool:
    """The checkpoint that ``train()`` wrote for ``arm``: every parameter
    (the table too) and every optimizer moment read back bit for bit, and
    the loaded network renders ``view`` as the arm's did."""
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.run import build_renderer
    from nerf_replication_tpu_torch.train import make_trainer
    from nerf_replication_tpu_torch.utils.ckpt_utils import (
        load_model,
        params_from_jax,
    )

    cfg, trainer = arm["cfg"], arm["trainer"]
    payload = load_model(cfg.trained_model_dir)
    net = make_network(cfg)
    net.load_state_dict(params_from_jax(payload["net"]))
    net = net.cuda()
    loaded = make_trainer(cfg, net)
    loaded.optimizer.load_state_dict(payload["optim"])
    ref = trainer.network.state_dict()
    params = all(torch.equal(v, ref[k]) for k, v in net.state_dict().items())
    table = tuple(payload["net"]["params"]["xyz_encoder"]["table"].shape)

    def moments(t):
        state = t.optimizer.state_dict()["optimizer"]["state"]
        return [v.cpu() for _, s in sorted(state.items())
                for _, v in sorted(s.items()) if torch.is_tensor(v)]

    ours, theirs = moments(loaded), moments(trainer)
    optim = (len(ours) == len(theirs) and loaded.step == trainer.step
             and all(torch.equal(a, b) for a, b in zip(ours, theirs)))
    again = build_renderer(cfg, net).render(view)[0].cpu().numpy()
    same = bool(np.array_equal(again, arm["images"][0]))
    print(f"NGP checkpoint round trip: {cfg.trained_model_dir} (epoch "
          f"{payload['epoch']}, table {table}): parameters bit-equal "
          f"{params}, {len(ours)} optimizer tensors bit-equal {optim} at "
          f"step {loaded.step}, view 0 renders "
          f"{'identically' if same else 'DIFFERENTLY'}")
    return params and optim and same and table == tuple(
        trainer.network.xyz_encoder.table.shape)


def ngp_train_arm(plain: bool, arrays, views, steps: int,
                  stops=(1, 2, 3, 4), label: str | None = None,
                  extra=()) -> dict:
    """One arm of phase 7 (and of phase 11, with the config options
    ``extra``) through the train CLI's ``train()``: epochs of ``steps //
    4`` steps from the fresh seed-0 init up to the first of ``stops``, then
    a run resumed from the checkpoint up to each later stop, with an eval
    through the eval renderer at every stop. ``plain`` forces the brick
    encoder's autograd.Function to its plain forward and backward on the
    card."""
    from nerf_replication_tpu_torch.evaluators import psnr_uint8
    from nerf_replication_tpu_torch.ops import hashgrid_kernel as hk
    from nerf_replication_tpu_torch.run import build_renderer
    from nerf_replication_tpu_torch.train.cli import train

    label = label or ("plain" if plain else "kernels")
    opts = [*extra, "ep_iter", str(steps // 4), "trained_model_dir",
            f"build/smoke_ngp_train_{label}"]

    def evaluate(net):
        renderer = build_renderer(cfg, net)   # packs the current table
        images = [renderer.render(view)[0].cpu().numpy() for view in views]
        return images, float(np.mean([psnr_uint8(img, view["colors"])
                                      for img, view in zip(images, views)]))

    forced = {"brick_hash_encode": hk.brick_encode_reference,
              "brick_hash_encode_bwd": hk.brick_encode_bwd_reference}
    counts, summaries, evals = dict.fromkeys(_counters(), 0), [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        for name, fn in (forced.items() if plain else ()):
            stack.enter_context(mock.patch.object(hk, name, fn))
        for epochs in stops:
            cfg = _ngp_train_cfg(*opts, "train.epoch", str(epochs), "resume",
                                 str(epochs != stops[0]))
            reset_counts()
            trainer = train(cfg, train_arrays=arrays, val_loader=views)
            counts = {k: counts[k] + n for k, n in read_counts().items()}
            summaries += trainer.summaries
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            images, evals[trainer.step] = evaluate(trainer.network)
    losses = np.concatenate([s["loss"] for s in summaries])
    psnrs = np.concatenate([s["psnr"] for s in summaries])
    arm = dict(cfg=cfg, model_dir=opts[-1], trainer=trainer, counts=counts,
               steps=trainer.step,
               losses=losses, images=images, evals=evals, peak_gb=peak_gb,
               eval_psnr=evals[trainer.step],
               rays_per_s=[s["rays_per_s"] for s in summaries])
    print(f"NGP train ({label}): {arm['steps']} steps in epochs "
          f"{[s['epoch'] for s in summaries]} (each after the first resumed "
          f"from the checkpoint), rays/s per epoch "
          f"{[round(r) for r in arm['rays_per_s']]}, final smoothed loss "
          f"{float(np.median(losses[-20:])):.5f}, train PSNR "
          f"{float(np.median(psnrs[-20:])):.2f} dB, peak memory in training "
          f"{peak_gb:.2f} GB, eval PSNR (hard test views 0, 4, 800x800, eval "
          f"renderer) by step "
          f"{ {step: round(db, 4) for step, db in evals.items()} }, counts in "
          f"training {counts}")
    return arm


def phase_ngp_train(arrays, views, steps: int, profile: int) -> dict:
    """Phase 7: the brick training kernels against plain at both layouts,
    the kernel arm, the plain arm and the checkpoint round trip. Returns
    the kernels' readings at the config's layout with their launches in
    the kernel arm's training."""
    res = None
    for log2_bricks in NGP_LAYOUTS:
        readings = brick_kernels_against_plain(log2_bricks, arrays)
        res = res or readings        # the config's layout comes first

    from nerf_replication_tpu_torch.train.cli import make_pipeline

    k = ngp_train_arm(False, arrays, views, steps)
    expect = dict.fromkeys(k["counts"], 0) | {
        "brick_fwd": 2 * steps, "brick_bwd": 2 * steps, "module": 2 * steps,
        "mlp": 2 * steps}
    if k["counts"] != expect or k["steps"] != steps:
        fail(f"the NGP kernel arm did not train through the brick kernels "
             f"alone: {k['counts']}")
    round_trip = ngp_checkpoint_round_trip(k, views[0])
    if profile:
        profile_steps(k["trainer"], make_pipeline(k["cfg"], arrays, "cuda"),
                      profile, "ngp_train")
    del k["trainer"]
    torch.cuda.empty_cache()

    # the plain arm takes ~170 ms a step, so it runs half the steps and the
    # arms are compared where both were evaluated
    p = ngp_train_arm(True, arrays, views, steps, stops=NGP_PLAIN_STOPS)
    done = p["steps"]
    expect = dict.fromkeys(p["counts"], 0) | {
        "plain": 4 * done, "module": 2 * done, "mlp": 2 * done}
    if p["counts"] != expect or 2 * done != steps:
        fail(f"the NGP plain arm did not train through the plain versions "
             f"alone: {p['counts']}")
    del p["trainer"]
    torch.cuda.empty_cache()
    for arm in (k, p):
        if not np.isfinite(arm["losses"]).all():
            fail("an NGP training loss is not finite")
        if arm["eval_psnr"] < NGP_TRAIN_PSNR_FLOOR_DB:
            fail(f"NGP eval PSNR {arm['eval_psnr']:.4f} dB below the floor "
                 f"{NGP_TRAIN_PSNR_FLOOR_DB} dB")
    means = [float(np.mean([arm["evals"][step] for step in p["evals"]]))
             for arm in (k, p)]
    diff = abs(means[0] - means[1])
    print(f"NGP arms: eval PSNR after {done} steps kernels "
          f"{k['evals'][done]:.4f} dB, plain {p['evals'][done]:.4f} dB; mean "
          f"of the evals at steps {list(p['evals'])} kernels {means[0]:.4f} "
          f"dB, plain {means[1]:.4f} dB, difference {diff:.4f} dB (<= "
          f"{NGP_ARMS_MAX_DIFF_DB}); train rays/s (epochs after the first) "
          f"kernels {np.mean(k['rays_per_s'][1:]):,.0f}, plain "
          f"{np.mean(p['rays_per_s'][1:]):,.0f}")
    if diff > NGP_ARMS_MAX_DIFF_DB:
        fail(f"the NGP arms' eval PSNRs differ by {diff:.4f} dB")
    if not round_trip:
        fail("the NGP checkpoint does not give back the trained state")
    res["launches"] = {"fwd": k["counts"]["brick_fwd"],
                       "bwd": k["counts"]["brick_bwd"]}
    res["evals"] = k["evals"]
    return res


def phase_probes() -> list[dict]:
    """Phase 8: scripts/probe_cuda_gather.py's probes; returns its
    readings, each with the launches its run made."""
    import importlib.util

    from nerf_replication_tpu_torch.utils import tracing

    spec = importlib.util.spec_from_file_location(
        "probe_cuda_gather", os.path.join(ROOT, "scripts",
                                          "probe_cuda_gather.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    keys = {f"probe_{w.__name__}": f"{w.__name__}.launches"
            for w in probe.PROBES}
    for key in keys.values():
        tracing.counts.pop(key, None)
    readings = probe.run()
    torch.cuda.synchronize()
    launches = {name: tracing.counts[key] for name, key in keys.items()}
    for r in readings:
        r["launches"] = launches[r["name"]]
        if not r["ok"] or not r["launches"]:
            fail(f"{r['name']} disagrees with PyTorch indexing or did not "
                 f"launch")
    return readings


# The frame path (phase 9). The JAX package's records on the same
# checkpoints and hard test views 0 and 4 (quality and ray counts only;
# no TPU time is the port's): the step that passed its gate, the test
# PSNR there against the dense render's, the grids' occupied shares, the
# ray counts at that step and the frame against the dense frame.
FRAME_RECORDS = {
    "freq_rm": {"step": (32, 12, 10), "psnr": 31.58, "dense_psnr": 31.75,
                "grids": (0.089, 0.053), "q_vs_dense_db": 40.5,
                "stats": {"active_rays": 202432, "occ_rays": 147481,
                          "nontrivial_rays": 125294}},     # BENCH_r05.json
    "ngp": {"step": (32, 10, 10), "psnr": 30.13, "dense_psnr": 30.28},
}                                      # RESULTS_r05.md, honest-gate record
FRAME_DROP_DB = 0.2     # bench.py's BENCH_NGP_GATE_DROP
FRAME_TIMED = 40        # synchronised frames timed after a warm-up
FRAME_WINDOW = 100      # frames of the overlapped window (seconds of them)
GRID_CHUNK = 65536      # the grid build's points a density call


def grid_against_plain(kernel_apply, plain_apply, settings, bounds: Bounds,
                       resolution: int, threshold: float) -> dict:
    """The density through the kernel and through its plain version at the
    centres of a ``resolution``^3 lattice, in the grid build's own chunks
    of GRID_CHUNK points: the kernel-against-plain check on the raw (N, 4)
    outputs, and the undilated occupancy of both. A cell may flip only
    where the plain density lies within the check's elementwise bound
    (atol + rtol x threshold) of the threshold."""
    from nerf_replication_tpu_torch.ops.occupancy import grid_points
    from nerf_replication_tpu_torch.ops.ray_ops import density_activation

    act = density_activation(settings.density_activation)
    pts = torch.from_numpy(grid_points(resolution, (-1.5,) * 3 + (1.5,) * 3))
    pts = pts.cuda()[:, None, :]
    zero = pts.new_zeros(1, 1, 3)
    with torch.inference_mode():
        raw_k, raw_p = (torch.cat([
            apply(pts[i:i + GRID_CHUNK], zero, "fine")[:, 0]
            for i in range(0, pts.shape[0], GRID_CHUNK)])
            for apply in (kernel_apply, plain_apply))
    a = agreement(raw_k, raw_p, bounds)
    d_k, d_p = act(raw_k[:, 3]), act(raw_p[:, 3])
    flips = (d_k > threshold) != (d_p > threshold)
    band = bounds.atol + bounds.rtol * threshold
    dist = (d_p[flips] - threshold).abs()
    a.update(flips=int(flips.sum()),
             flip_max_dist=float(dist.max()) if len(dist) else 0.0,
             band=band, occupied=float((d_p > threshold).float().mean()))
    a["ok"] = a["ok"] and a["flip_max_dist"] <= band
    return a


def plain_twin(net, mlp_bf16: bool = False):
    """The eval apply of ``net`` that the frame path uses, with its kernel
    wrapper replaced by the kernel's plain version (the same weights, the
    same inputs): #10 (the arm ``mlp_bf16`` names) for a brick-NGP
    network, #1 for a frequency one; an xla-grid network runs no kernel,
    so its nn.Module is its own plain twin."""
    from nerf_replication_tpu_torch.models.nerf.renderer import ngp_renderer
    from nerf_replication_tpu_torch.ops import fused_ngp, mlp_kernel

    if ngp_renderer.is_xla_ngp(net):
        print("xla hash grid: the nn.Module network is its own plain twin")
        return net
    if ngp_renderer.is_brick_ngp(net):
        apply = ngp_renderer.make_ngp_eval_apply(net, mlp_bf16=mlp_bf16)
        patch = (fused_ngp, "fused_ngp_eval",
                 fused_ngp.fused_ngp_eval_reference)
    else:
        apply = mlp_kernel.make_fused_apply(net)
        patch = (mlp_kernel, "fused_nerf_mlp_enc",
                 mlp_kernel.fused_nerf_mlp_enc_reference)

    def plain(pts, viewdirs, model):
        with mock.patch.object(*patch):
            return apply(pts, viewdirs, model)
    return plain


def frame_chunks_against_plain(tag: str, apply_fn, plain, frame_args,
                               chosen, pose, bounds: Bounds) -> list[dict]:
    """The kernel against its plain version on what one frame gives it:
    a frame at the passing step is rendered with ``apply_fn`` recording
    its calls, and the samples of its first coarse chunk and its first
    fine chunk go through ``apply_fn`` and ``plain``; fails the run where
    they disagree. Returns the two readings."""
    from nerf_replication_tpu_torch import raymarch_bench as rb

    seen = []

    def record(pts, viewdirs, model=""):
        seen.append((pts.clone(), viewdirs.clone(), model))
        return apply_fn(pts, viewdirs, model)

    fn = rb.frame_factory(record, *frame_args)(
        *chosen["step"], chosen["caps"], *chosen["probe"])
    fn(pose)
    b = fn.budget
    readings = []
    for branch, call in (("coarse", 0),
                         ("fine", b["coarse_rays"] // b["chunk"])):
        pts, viewdirs, model = seen[call]
        with torch.inference_mode():
            out_k = apply_fn(pts, viewdirs, model).reshape(-1, 4)
            out_p = plain(pts, viewdirs, model).reshape(-1, 4)
        a = agreement(out_k, out_p, bounds)
        print(f"frame path {tag}: kernel vs plain on the first "
              f"{branch} chunk of a frame, {tuple(pts.shape[:2])} samples: "
              f"{describe(a)}")
        if not a["ok"]:
            fail(f"the {tag} kernel disagrees with its plain "
                 f"version on the frame's {branch} chunk")
        readings.append({"n": out_k.shape[0], "err": a["max_abs_err"]})
    return readings


def frame_seconds(fn, pose, n: int) -> tuple[list[float], list[float]]:
    """``n`` frames, each synchronised: the host's seconds to issue each
    (until ``fn`` returns) and its wall seconds to a synchronised card,
    each list sorted."""
    issue, wall = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(pose)
        issue.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    return sorted(issue), sorted(wall)


def frame_times(tag: str, fn, pose, poses) -> dict:
    """Seconds a frame of ``fn``, printed: synchronised frames (median of
    FRAME_TIMED, with the host's issue time), and ``raymarch_bench``'s
    overlapped window over ``poses``, twice."""
    from nerf_replication_tpu_torch import raymarch_bench as rb

    issue, wall = frame_seconds(fn, pose, FRAME_TIMED)
    rb.time_frames(fn, poses[:1])
    windows = [rb.time_frames(fn, poses) for _ in range(2)]
    res = {"seconds": float(np.median(wall)),
           "issue": float(np.median(issue)), "window": windows}
    print(f"frame path {tag}: synchronised {1e3 * res['seconds']:.2f}"
          f" ms a frame (median of {FRAME_TIMED}, {1e3 * wall[0]:.2f}-"
          f"{1e3 * wall[-1]:.2f}), the host's issue {1e3 * res['issue']:.2f}"
          f" ms of it; overlapped windows of {len(poses)} orbit frames "
          f"{1e3 * windows[0]:.2f} / {1e3 * windows[1]:.2f} ms a frame "
          f"({1 / windows[0]:.2f} / {1 / windows[1]:.2f} fps)")
    return res


def phase_frame(family: str, argv, views, dense: dict, bounds: Bounds,
                kernel_key: str) -> dict:
    """Phase 9, one family: the occupancy-raymarch frame path at 800x800
    through its kernel (``kernel_key`` in the launch counts), gated on
    hard test views 0 and 4 against the dense render ``dense`` (a
    ``run_evaluate`` result of the same views). Returns its readings."""
    from nerf_replication_tpu_torch import raymarch_bench as rb
    from nerf_replication_tpu_torch.config import make_cfg, parse_args
    from nerf_replication_tpu_torch.run import (
        build_grids,
        build_renderer,
        load_model,
    )

    record = FRAME_RECORDS[family]
    cfg = make_cfg(parse_args(argv))
    net = load_model(cfg, torch.device("cuda"))
    renderer = build_renderer(cfg, net)
    settings, apply_fn = renderer.settings, renderer.apply_fn
    H, W = int(views[0]["H"]), int(views[0]["W"])
    focal = float(views[0]["focal"])
    out = {"family": family}

    # (a) the grids, through the kernel, and the kernel against its plain
    # version at the grids' lattice points
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    occupancy, select = build_grids(apply_fn, settings, "cuda")
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    counts = read_counts()
    fractions = (occupancy[0].float().mean().item(),
                 select[0].float().mean().item())
    print(f"frame path {family}: grids 64^3 / 128^3 {fractions[0]:.4f} / "
          f"{fractions[1]:.4f} occupied (JAX record 0.089 / 0.053 for "
          f"freq_rm), built in {grid_s:.3f} s with {counts[kernel_key]} "
          f"launches, plain calls {counts['plain'] + counts['module']}")
    if counts[kernel_key] == 0 or counts["plain"] or counts["module"]:
        fail(f"the {family} grids were not built through the kernel alone: "
             f"{counts}")
    plain = plain_twin(net)
    for res, thr in ((64, 0.02), (128, 0.02)):
        a = grid_against_plain(apply_fn, plain, settings, bounds, res, thr)
        print(f"frame path {family}: grid {res}^3 kernel vs plain: "
              f"{describe(a)}; undilated cells flipped {a['flips']} "
              f"(farthest {a['flip_max_dist']:.2e} from the threshold, "
              f"band {a['band']:.2e}), plain occupied {a['occupied']:.4f}")
        if not a["ok"]:
            fail(f"the {family} grid {res}^3 through the kernel disagrees "
                 f"with its plain version")
        out.setdefault("checks", []).append({"err": a["max_abs_err"]})
    torch.cuda.empty_cache()

    # (b) the gated frame (raymarch_bench's): the ladder from the JAX
    # record's passing step, with autocap; the bf16 arm for NGP
    dense_imgs = [np.clip(rgb, 0, 1) for rgb in dense["rgb"]]
    gate = rb.Gate(views, dense_imgs, True, dense["psnr"], FRAME_DROP_DB)
    ladder = rb.parse_ladder(rb.DEFAULT_LADDER)
    ladder = [record["step"]] + ladder[ladder.index(record["step"]) + 1:]
    frame_args = (H, W, focal, occupancy, select, settings)
    chosen, bf16 = rb.gated_frame(net, apply_fn, frame_args, gate, ladder,
                                  views[0]["pose"])
    if chosen is None:
        fail(f"the {family} frame path passed no ladder step of the gate")
    info, stats, caps = chosen["info"], chosen["stats"], chosen["caps"]
    fn = chosen["fn"]
    print(f"frame path {family}: gate passed at C,M,F={chosen['step']} "
          f"(JAX record {record['step']}): test PSNR {info['psnr']:.4f} dB, "
          f"drop {info['drop']:+.4f} dB against the port's dense "
          f"{dense['psnr']:.4f} dB (budget {FRAME_DROP_DB}; JAX record "
          f"{record['psnr']} against {record['dense_psnr']}), "
          f"{info['q_vs_dense_db']:.2f} dB against the dense frame"
          + (f" (JAX record {record['q_vs_dense_db']})"
             if "q_vs_dense_db" in record else ""))
    print(f"frame path {family}: stats {stats} (JAX record "
          f"{record.get('stats', 'not recorded')}), caps {caps}, probe "
          f"{chosen['probe']}, budget {fn.budget}")

    # (c) one frame's launches, the kernel against plain on the frame's
    # chunks, a frame under sync debug, times, profile
    pose = torch.as_tensor(views[0]["pose"], device="cuda")
    poses = [torch.as_tensor(p, device="cuda")
             for p in rb.orbit_poses(FRAME_WINDOW)]
    b = fn.budget
    calls = (b["coarse_rays"] + b["fine_rays"] * b["fine_rounds"]) \
        // b["chunk"]

    def launches(frame_fn, key):
        frame_fn(pose)
        torch.cuda.synchronize()
        reset_counts()
        frame_fn(pose)
        torch.cuda.synchronize()
        counts = read_counts()
        print(f"frame path {family}: one frame's counts {counts} (expected "
              f"{key} {calls}, every other 0)")
        if counts != dict.fromkeys(counts, 0) | {key: calls}:
            fail(f"the {family} frame did not run through {key} alone: "
                 f"{counts}")
        return counts[key]

    tag = family if bf16 is None else f"{family} f32 arm"
    out["frame_launches"] = launches(fn, kernel_key)
    out["checks"] += frame_chunks_against_plain(
        tag, apply_fn, plain, frame_args, chosen, pose, bounds)
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(pose)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"frame path {family}: a warmed frame ran under "
          "torch.cuda.set_sync_debug_mode('error')")
    torch.cuda.reset_peak_memory_stats()
    times = frame_times(tag, fn, pose, poses)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    build = rb.frame_factory(apply_fn, *frame_args)
    stage_ms = {}
    for stage in ("probe", "coarse"):
        part = build(*chosen["step"], caps, *chosen["probe"], stage=stage)
        stage_ms[stage] = 1e3 * float(np.median(
            frame_seconds(part, pose, FRAME_TIMED)[1]))
    full_ms = 1e3 * times["seconds"]
    print(f"frame path {family}: {times['seconds']:.4f} s a frame "
          f"synchronised against the dense "
          f"{[round(t, 3) for t in dense['net_time']]} s; by stage "
          f"(truncated frames, synchronised): probe + compaction "
          f"{stage_ms['probe']:.2f} ms, selection + coarse "
          f"{stage_ms['coarse'] - stage_ms['probe']:.2f} ms, fine + "
          f"scatter {full_ms - stage_ms['coarse']:.2f} ms; peak memory "
          f"{peak_gb:.2f} GB")
    out["busy_ms"] = profile_runs(lambda: fn(pose), 1, "frame",
                                  f"frame_{family}", warm=1)
    # what phase 13 renders again, sharded
    out["spec"] = {"occupancy": occupancy, "select": select,
                   "settings": settings, "step": chosen["step"],
                   "caps": dataclasses.asdict(caps), "probe": chosen["probe"]}
    out.update(step=chosen["step"], psnr=info["psnr"], drop=info["drop"],
               stats=stats, **times)

    # (d) NGP: the fused kernel's bf16 arm at the passing step, gated in
    # (b) and adopted only if it passed
    if bf16 is not None:
        print(f"frame path {family} bf16 arm: "
              f"{'PASSED, adopted' if bf16['passed'] else 'failed'}: test "
              f"{bf16['psnr']:.4f} dB, drop {bf16['drop']:+.4f} dB")
        fn16 = bf16["fn"]
        out["bf16"] = {
            "passed": bf16["passed"], "psnr": bf16["psnr"],
            "drop": bf16["drop"],
            "frame_launches": launches(fn16, "ngp_bf16"),
            "checks": frame_chunks_against_plain(
                f"{family} bf16 arm", bf16["apply"], plain_twin(net, True),
                frame_args, chosen, pose, NGP_BF16_BOUNDS),
            **frame_times(f"{family} bf16 arm", fn16, pose, poses)}
    del renderer, net
    torch.cuda.empty_cache()
    return out


# The compacted frequency frame (phase 10). The JAX package's record of
# bench.py's freq family on data/pretrain/hard at 800x800 (quality and ray
# counts only; no TPU time is the port's): result/bench_freq_r5.log.
COMPACT_RECORD = {"grid": 0.089, "q_vs_dense_db": 71.4,
                  "first": {"active_rays": 180000, "coarse_rays": 280000,
                            "coarse_overflow": 0, "fine_overflow": 0},
                  "stats": {"active_rays": 180000, "coarse_rays": 240000,
                            "coarse_overflow": 0, "fine_overflow": 0}}
FAST_RENDER_MAX_DB = 0.02   # render_image_fast's PSNR against the dense one
# one masked training batch: the fused arm against the nn.Module arm, the
# bounds of tests/test_torch_fast_render.py (the JAX package's own arms
# read 3.1% apart in gradient norm on 48 of these rays)
ARMS_LOSS_REL, ARMS_GRAD_REL = 2e-3, 5e-2


def masked_batch_checks(cfg, arrays) -> dict:
    """Phase 10 (f): phase 4's checks of #3 and #5 against their plain
    versions on one real 1024-ray batch of ``cfg`` (``fast_sampling`` on),
    then the batch's loss and leaf gradients through the fused arm (its
    launches counted) against the nn.Module arm, the same seed for both.
    Returns phase 4's readings."""
    from nerf_replication_tpu_torch.run import load_model
    from nerf_replication_tpu_torch.train import make_trainer
    from nerf_replication_tpu_torch.train.cli import make_pipeline

    print("masked batch (task_arg.fast_sampling): phase 4's checks")
    readings = phase_train_kernels(cfg, arrays)
    arms = {}
    for fused in (True, False):
        cfg_arm = cfg.clone()
        cfg_arm.network.use_pallas_mlp_train = fused
        net = load_model(cfg_arm, torch.device("cuda"))
        wrapper = make_trainer(cfg_arm, net).wrapper
        gen = torch.Generator(device="cuda").manual_seed(0)
        rays = make_pipeline(cfg_arm, arrays, "cuda").sample(gen, 1 << 30)
        reset_counts()
        loss, _ = wrapper.loss_fn(rays, gen, train=True)
        loss.backward()
        torch.cuda.synchronize()
        arms[fused] = (float(loss.detach()), torch.cat(
            [p.grad.ravel() for _, p in net.named_parameters()]),
            read_counts())
    (loss_k, grad_k, counts), (loss_m, grad_m, _) = arms[True], arms[False]
    loss_rel = abs(loss_k - loss_m) / abs(loss_m)
    grad_rel = float((grad_k - grad_m).norm() / grad_m.norm())
    print(f"masked batch, fused arm against nn.Module arm: loss {loss_k:.6f} "
          f"/ {loss_m:.6f} (rel {loss_rel:.2e} <= {ARMS_LOSS_REL}), all "
          f"leaves rel-norm {grad_rel:.2e} (<= {ARMS_GRAD_REL}); the fused "
          f"arm's counts {counts}")
    if (counts["fwd"], counts["bwd"], counts["plain"], counts["module"]) \
            != (2, 2, 0, 0):
        fail(f"the masked batch did not run through #3-#5 alone: {counts}")
    if loss_rel > ARMS_LOSS_REL or grad_rel > ARMS_GRAD_REL:
        fail("the masked batch's fused arm disagrees with the nn.Module arm")
    torch.cuda.empty_cache()
    return readings


def compact_chunks_against_plain(renderer, net, frame_args, caps,
                                 pose) -> list[dict]:
    """Phase 10 (d): #1 against its plain version on what the compacted
    frame gives it: the first coarse chunk and the first fine chunk of
    the 1-segment frame, and both ERT segments of the first fine chunk of
    the 2-segment frame; fails the run where they disagree."""
    from nerf_replication_tpu_torch.models.nerf.renderer import Renderer

    H, W, focal, occupancy = frame_args
    plain = plain_twin(net)
    readings = []
    for segments in (1, 2):
        seen = []

        def record(pts, viewdirs, model=""):
            seen.append((pts.clone(), viewdirs.clone(), model))
            return renderer.apply_fn(pts, viewdirs, model)

        r = Renderer(net, settings=dataclasses.replace(
            renderer.settings, ert_segments=segments)).use_apply(record)
        fn = r.make_frame_renderer(H, W, focal, capacity=caps[0],
                                   coarse_capacity=caps[1],
                                   occupancy=occupancy)
        fn(pose)
        first_fine = fn.budget["coarse_rays"] // fn.budget["chunk"]
        picks = ({"coarse chunk": 0, "fine chunk": first_fine}
                 if segments == 1 else
                 {"ERT segment 1": first_fine,
                  "ERT segment 2": first_fine + 1})
        for label, call in picks.items():
            pts, viewdirs, model = seen[call]
            with torch.inference_mode():
                out_k = renderer.apply_fn(pts, viewdirs, model).reshape(-1, 4)
                out_p = plain(pts, viewdirs, model).reshape(-1, 4)
            a = agreement(out_k, out_p)
            print(f"compacted frame: kernel vs plain on the {label}, "
                  f"{tuple(pts.shape[:2])} samples: {describe(a)}")
            if not a["ok"]:
                fail(f"the kernel disagrees with its plain version on the "
                     f"compacted frame's {label}")
            readings.append({"n": out_k.shape[0], "err": a["max_abs_err"]})
        del seen
    torch.cuda.empty_cache()
    return readings


def phase_compact(argv, views, dense: dict, arrays) -> dict:
    """Phase 10: the compacted frequency frame
    (``Renderer.make_frame_renderer``, raymarch_bench's ``freq`` family)
    at 800x800 through #1/#2, ``render_image_fast`` through ``run
    --type evaluate``, and one masked training batch through #3-#5.
    ``dense`` is phase 3's run_evaluate result. Returns its readings."""
    from nerf_replication_tpu_torch import raymarch_bench as rb
    from nerf_replication_tpu_torch.config import make_cfg, parse_args
    from nerf_replication_tpu_torch.evaluators import psnr_uint8
    from nerf_replication_tpu_torch.run import (
        build_grids,
        build_renderer,
        load_model,
        run_evaluate,
    )

    record = COMPACT_RECORD
    cfg = make_cfg(parse_args(argv))
    net = load_model(cfg, torch.device("cuda"))
    renderer = build_renderer(cfg, net)
    H, W = int(views[0]["H"]), int(views[0]["W"])
    focal = float(views[0]["focal"])
    out = {}

    # (a) the grid
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    occupancy, _ = build_grids(renderer.apply_fn, renderer.settings, "cuda",
                               rb.FREQ_OCC_RES, 0, rb.FREQ_OCC_THRESH)
    torch.cuda.synchronize()
    counts = read_counts()
    share = occupancy[0].float().mean().item()
    print(f"compacted frame: grid {rb.FREQ_OCC_RES}^3 threshold "
          f"{rb.FREQ_OCC_THRESH} dilated 2: {share:.4f} occupied (JAX record "
          f"{record['grid']}), built in {time.perf_counter() - t0:.3f} s "
          f"with {counts['enc']} launches of #1")
    if not counts["enc"] or counts["plain"] or counts["module"]:
        fail(f"the compacted frame's grid was not built through #1: {counts}")

    # (b), (c) the frame of orbit pose 0, autocap, the ERT gate
    poses = [torch.as_tensor(p, device="cuda")
             for p in rb.orbit_poses(FRAME_WINDOW)]
    frame = rb.compact_frame(renderer, H, W, focal, occupancy, poses[0],
                             log=lambda m: print(f"compacted frame: {m}"))
    stats, caps = frame["stats"], frame["caps"]
    print(f"compacted frame: stats {stats} after autocap to fine "
          f"{caps[0]:.4f} / coarse {caps[1]:.4f} (JAX record "
          f"{record['stats']}, first frame {record['first']}); ERT frame "
          f"{frame['ert_stats']}")
    print(f"compacted frame: ERT gate {frame['q_vs_dense_db']:.2f} dB of the "
          f"2-segment frame against the 1-segment one (>= {rb.ERT_GATE_DB}; "
          f"JAX record {record['q_vs_dense_db']}), {frame['gate']['kind']}")
    if frame["gate"]["kind"] != "freq-ert":
        fail("the ERT gate failed: the 2-segment frame lies below "
             f"{rb.ERT_GATE_DB} dB of the 1-segment one")
    gate = rb.Gate(views, [np.clip(rgb, 0, 1) for rgb in dense["rgb"]], True,
                   dense["psnr"], FRAME_DROP_DB,
                   log=lambda m: print(f"compacted frame: {m}"))
    drops = {name: gate(frame[key], f"GT-drop check ({name})")
             for name, key in (("ERT", "ert_fn"), ("1-segment", "dense_fn"))}
    if not drops["ERT"][0]:
        fail(f"the adopted compacted frame drops "
             f"{drops['ERT'][1]['drop']:.4f} dB below the dense render")

    # (d) #1 against plain on the frame's own chunks
    checks = compact_chunks_against_plain(
        renderer, net, (H, W, focal, occupancy), caps, poses[0])

    # (e) render_image_fast through run --type evaluate
    reset_counts()
    fast = run_evaluate(make_cfg(parse_args(argv + [
        "task_arg.fast_sampling", "True"])), loader=views)
    counts = read_counts()
    vs_dense = psnr_uint8(fast["rgb"][0], dense["rgb"][0])
    print(f"render_image_fast (run --type evaluate, task_arg.fast_sampling): "
          f"PSNR {fast['psnr']:.4f} dB against the dense {dense['psnr']:.4f}"
          f" (<= {FAST_RENDER_MAX_DB} dB apart), view 0 against the dense "
          f"render {vs_dense:.2f} dB, frame times "
          f"{[round(t, 3) for t in fast['net_time']]} s (dense "
          f"{[round(t, 3) for t in dense['net_time']]}), counts {counts}")
    if abs(fast["psnr"] - dense["psnr"]) > FAST_RENDER_MAX_DB \
            or not counts["enc"] or counts["plain"] or counts["module"]:
        fail("render_image_fast is not the dense render through #1")

    # (f) one masked training batch
    train_cfg = make_cfg(parse_args(TRAIN_ARGV + [
        "pretrain_path", "data/pretrain/hard", "task_arg.fast_sampling",
        "True"]))
    out["train"] = masked_batch_checks(train_cfg, arrays)

    # (g) one frame's launches, a frame under sync debug, times, profile
    b = frame["ert_fn"].budget
    calls = (b["coarse_rays"] + b["fine_rays"] * b["fine_segments"]) \
        // b["chunk"]
    fns = {"ERT": frame["ert_fn"], "1-segment": frame["dense_fn"]}
    fns["ERT"](poses[0])
    torch.cuda.synchronize()
    reset_counts()
    fns["ERT"](poses[0])
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"compacted frame: one ERT frame's counts {counts} (expected enc "
          f"{calls}, every other 0)")
    if counts != dict.fromkeys(counts, 0) | {"enc": calls}:
        fail(f"the compacted frame did not run through #1 alone: {counts}")
    torch.cuda.set_sync_debug_mode("error")
    try:
        fns["ERT"](poses[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("compacted frame: a warmed frame ran under "
          "torch.cuda.set_sync_debug_mode('error')")
    torch.cuda.reset_peak_memory_stats()
    times = {name: frame_times(f"compacted frame ({name})", fn, poses[0],
                               poses) for name, fn in fns.items()}
    dense_s = [round(t, 3) for t in dense["net_time"]]
    print(f"compacted frame: dense frame {dense_s} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    out["busy_ms"] = profile_runs(lambda: fns["ERT"](poses[0]), 1, "frame",
                                  "frame_compact", warm=1)
    out["spec"] = {"occupancy": occupancy, "caps": caps}  # for phase 13
    out.update(checks=checks, frame_launches=counts["enc"], stats=stats,
               caps=caps, gate=frame["q_vs_dense_db"], drops=drops,
               fast_psnr=fast["psnr"], times=times)
    del renderer, net
    torch.cuda.empty_cache()
    return out


# -- phase 11: the vertex-exact xla hash grid and the composite encoders --

XLA_OPTS = ("network.xyz_encoder.backend", "xla")
# The xla encode on the card against the same function on the CPU. The
# corner rows and weights come from the same f32 points on both (both
# bit-equal); the forward's reference sums the products in f64. The card's
# f32 sum of 8 products is within 15 roundings of 2^-24 of the sum of
# |w v|, which is at most max |table| (the weights sum to 1):
# XLA_FWD_TOL x max |table|.
XLA_FWD_TOL = 1e-6
# Table gradient: the f32 contributions w x g (bit-equal on both) added on
# the card in any order (atomics) against their f64 sum; a row of n
# contributions lies within n x 2^-24 of the sum of their |value|, the
# worst case of any summation order, and a row no corner touches is
# exactly zero. Input gradient: the card against the CPU's f32
# run, which differ in summation order alone: within XLA_DX_TOL of the
# column's max |dx|.
XLA_DX_TOL = 1e-5
# The bf16 arm against its own CPU run: one bf16 rounding of an f32 sum of
# the C = 2^D corners' bf16 products, added in another order: the two f32
# sums lie within 2 C x 2^-24 of the sum of |products| (at most max
# |table|) of each other, and their roundings at most one bf16 step (2^-7
# of the element) further apart (:func:`xla_bf16_agreement`); most are
# bit-equal.
XLA_BF16_REL = 2.0 ** -7
XLA_BF16_EQUAL = 0.99
XLA_REPS = 5
COMPOSITES = ("triplane", "cuda_triplane", "cuda_hashgrid_latent",
              "cuda_hashgrid_4d", "cuda_hashgrid_coef", "cuda_motion2d",
              "dnerf", "dnerf_mlp_tensorf", "dnerf_ngp_mlp",
              "dnerf_ngp_tensorf", "cuda_dnerf_ngp_tensorf")
COMPOSITE_POINTS = 65_536
# The composites on the card against the CPU in float64, on points
# rounded to float32 (so the float32 run sees the same points): the same
# arithmetic in another order. Where a coordinate comes out of a warp
# (Motion2D, the D-NeRF family: COMPOSITE_WARPS), the two may round it one
# f64 ulp apart, which the defaults' finest level (16 x 2^15 cells a side)
# magnifies ~5e5-fold: those read up to 4.36e-10 of a leaf's max on the
# H100, the others <= ~2e-15 (PERF.md section 6). Every
# output and gradient element within COMPOSITE_F64_TOL of its leaf's max
# |value| where no point is moved, COMPOSITE_F64_WARP_TOL where one is
# (each bound ~5x above its encoders' readings). The card's
# float32 run against the CPU's float32 run on the same points and
# weights, each leaf by its relative Frobenius norm: within
# COMPOSITE_F32_TOL where no point is moved (the same arithmetic but for
# the order of GEMM and index_add_ sums; read <= 3.6e-6, the latent
# codes' gradient, on the H100); where an MLP or a tensor moves the
# points (COMPOSITE_WARPS), within COMPOSITE_F32_WARP_TOL times the CPU's
# own float32 error against its float64 run, since cuBLAS and the CPU
# round the moved coordinates apart and a moved coordinate one ulp apart
# is a few hundredths of a finest cell, so those leaves are as far apart
# as float32 is from exact (read <= 1.30, Motion2D's output layer).
# Equal float32 errors on both devices put that ratio at <= 2. The card's
# float32 run against its float64 one is reported, not gated: the
# normalisation's f32 rounding alone moves a coordinate by hundredths of
# a finest cell.
COMPOSITE_F64_TOL = 1e-14
COMPOSITE_F64_WARP_TOL = 2e-9
COMPOSITE_F32_TOL = 5e-5
COMPOSITE_F32_WARP_TOL = 2.0
COMPOSITE_WARPS = ("cuda_motion2d", "dnerf", "dnerf_mlp_tensorf",
                   "dnerf_ngp_mlp", "dnerf_ngp_tensorf",
                   "cuda_dnerf_ngp_tensorf")


def xla_forward_f64(layout, table, x):
    """The xla encode's reference on the CPU: the corner rows and weights
    of the f32 points ``x``, the products summed in float64. Returns
    (features, rows, weights)."""
    from nerf_replication_tpu_torch.models.encoding import hashgrid as hg

    idx, w = hg._indices_weights(layout, x.cpu())
    n, L, F = x.shape[0], len(layout.scales), layout.n_features
    vals = table.detach().cpu().double()[idx.reshape(-1)].reshape(n, L, -1, F)
    out = (w.double().reshape(n, L, -1, 1) * vals).sum(2)
    return out.reshape(n, L * F), idx, w


def xla_bf16_agreement(out16, ref16, layout, table) -> tuple:
    """The bf16 arm's features against its CPU run: (within the bound,
    max error, the share bit-equal)."""
    err = (out16.cpu() - ref16).abs()
    limit = (XLA_BF16_REL * ref16.abs() + 2 * 2 ** layout.input_dim
             * 2.0 ** -24 * float(table.abs().max()))
    return (bool((err <= limit).all()), float(err.max()),
            float((err == 0).float().mean()))


def xla_table_grad_f64(layout, x, g, rows: int):
    """The table gradient's f32 contributions on the CPU, summed in f64 by
    row, with the f64 sums of their |value| and their count a row."""
    from nerf_replication_tpu_torch.models.encoding import hashgrid as hg

    idx, w = hg._indices_weights(layout, x.cpu())
    n, L, F = x.shape[0], len(layout.scales), layout.n_features
    u = (w.reshape(n, L, -1, 1) * g.cpu().reshape(n, L, 1, F)).reshape(-1, F)
    ids, u = idx.reshape(-1), u.double()
    zeros = torch.zeros(rows, F, dtype=torch.float64)
    count = torch.zeros(rows, dtype=torch.float64).index_add_(
        0, ids, torch.ones(ids.shape[0], dtype=torch.float64))
    return (zeros.index_add(0, ids, u), zeros.index_add(0, ids, u.abs()),
            count)


def xla_grad_agreement(dtable, ref) -> dict:
    """A table gradient against :func:`xla_table_grad_f64`'s sums: ``ok``
    when finite and every element within its row's worst-case summation
    bound (rows no corner touches: exactly zero); ``worst`` is the largest
    error over its bound."""
    sums, absum, count = ref
    err = (dtable.cpu().double() - sums).abs()
    limit = count[:, None] * 2.0 ** -24 * absum
    untouched = count == 0
    return dict(ok=bool(torch.isfinite(dtable).all())
                and bool((err <= limit).all()),
                worst=float((err / limit.clamp_min(1e-300))[~untouched].max()),
                untouched_zero=not bool(dtable.cpu()[untouched].any()),
                max_abs_err=float(err.max()))


def xla_encode_against_cpu(arrays, views) -> dict:
    """Phase 11 (a): the xla encode of hard_ngp.yaml (backend xla; a seeded
    U(-1, 1) table) on the points of one real training batch and of one
    eval chunk, against the CPU; its times, #6/#7's on the training
    points, and its byte bound. Returns the readings by size."""
    from nerf_replication_tpu_torch.models.encoding import hashgrid as hg
    from nerf_replication_tpu_torch.ops import hashgrid_kernel as hk

    cfg = _ngp_train_cfg(*XLA_OPTS)
    net, batches = encoder_real_batch(cfg, arrays, warm=False)
    enc = net.xyz_encoder
    layout = enc.layout
    rows, F = enc.table.shape
    L = len(layout.scales)
    print(f"xla grid of hard_ngp.yaml: {L} levels {layout.scales}, "
          f"{sum(layout.use_hash)} of them hashed (2^19 rows), {rows:,} rows "
          f"x {F} features ({rows * F * 4 / 1e6:.1f} MB in f32)")
    with torch.no_grad():
        chunk = ngp_chunk_samples(cfg, net, views[0])
    points = [(f"train {b}", x, True) for b, (x, _) in zip(("coarse", "fine"),
                                                           batches)]
    points += [(f"eval {b}", enc.to_unit(chunk[b][0].reshape(-1, 3)), False)
               for b in ("coarse", "fine")]
    del net, batches, chunk
    gen = torch.Generator(device="cuda").manual_seed(11)
    table = torch.empty(rows, F, device="cuda").uniform_(-1, 1, generator=gen)
    table16 = table.to(torch.bfloat16)
    blayout = hk.make_brick_layout(L, 16, 512, log2_bricks=12)
    btable = torch.empty(blayout.n_rows, hk.ROW, device="cuda").uniform_(
        -1, 1, generator=gen)
    flops_pt = L * (2 ** 3 * (2 * F + 3))     # weights, products, sums
    out_res = []
    for tag, x, train in points:
        n = x.shape[0]
        x = x.contiguous()
        with torch.no_grad():
            out = hg.hash_encode(layout, table, x)
            out16 = hg.hash_encode(layout, table16, x)
            idx, w = hg._indices_weights(layout, x)
        ref, idx_cpu, w_cpu = xla_forward_f64(layout, table, x)
        same_rows = torch.equal(idx.cpu(), idx_cpu)
        same_w = torch.equal(w.cpu(), w_cpu)
        del idx, w, idx_cpu, w_cpu
        err = float((out.cpu().double() - ref).abs().max())
        limit = XLA_FWD_TOL * float(table.abs().max())
        ref16 = hg.encode_forward(layout, table16.cpu(), x.cpu())
        ok16, err16, equal16 = xla_bf16_agreement(out16, ref16, layout,
                                                  table)
        fwd = cuda_times(lambda: hg.hash_encode(layout, table, x), XLA_REPS)
        fwd16 = cuda_ms(lambda: hg.hash_encode(layout, table16, x), XLA_REPS)
        reading = dict(n=n, err=err, ms=fwd[TIMING_ROUNDS // 2],
                       bf16_ms=fwd16, **bound(
                           nbytes(x, out) + n * 8 * L * F * 4,
                           n * flops_pt, "f32"))
        print(f"xla encode vs the CPU in f64, {tag} N={n}: rows bit-equal "
              f"{same_rows}, weights bit-equal {same_w}; max_abs_err "
              f"{err:.3e} (<= {limit:.3e}); bf16 arm vs its CPU run: max err "
              f"{err16:.3e} (within its bound: {ok16}), "
              f"bit-equal {equal16:.4%} (>= {XLA_BF16_EQUAL:.0%}) | forward "
              f"{spread(fwd)}, bf16 {fwd16:.4f} ms, bound "
              f"{reading['bound_ms']:.4f} ms by {reading['bound_by']} "
              f"({reading['bound_ms'] / reading['ms']:.1%} of it reached)")
        if not (same_rows and same_w and err <= limit and ok16
                and equal16 >= XLA_BF16_EQUAL
                and bool(torch.isfinite(out).all())):
            fail(f"the xla encode disagrees with the CPU, {tag}")
        if train:
            reading.update(xla_backward_against_cpu(
                tag, layout, table, x, rows, blayout, btable))
        out_res.append(reading)
        del out, out16, ref, ref16
        torch.cuda.empty_cache()
    return {"readings": out_res, "rows": rows}


def xla_backward_against_cpu(tag, layout, table, x, rows, blayout,
                             btable) -> dict:
    """Phase 11 (a) on a training batch's points: the table gradient for a
    seeded cotangent and the input gradient against the CPU, the
    backward's times, one ``index_add_`` of its contributions, the sort
    of their rows that the JAX package's ``sorted_bwd`` would add, and
    #6/#7 on the same points."""
    from nerf_replication_tpu_torch.models.encoding import hashgrid as hg
    from nerf_replication_tpu_torch.ops import hashgrid_kernel as hk

    n, L, F = x.shape[0], len(layout.scales), layout.n_features
    g = torch.randn(n, L * F, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(12))
    ref = xla_table_grad_f64(layout, x, g, rows)
    dtable = hg.encode_backward(layout, table, x, g, True, False)[0]
    a = xla_grad_agreement(dtable, ref)
    res = {"bwd_err": a["max_abs_err"], "bwd_ms": cuda_ms(
        lambda: hg.encode_backward(layout, table, x, g, True, False),
        XLA_REPS)}
    print(f"xla table gradient vs f64 sums on the CPU, {tag}: worst error / "
          f"its row's summation bound {a['worst']:.2e} (<= 1), untouched "
          f"rows exactly zero {a['untouched_zero']}, max_abs_err "
          f"{a['max_abs_err']:.3e}")
    if not (a["ok"] and a["untouched_zero"]):
        fail(f"the xla table gradient disagrees with the CPU, {tag}")
    del dtable
    with_dx = layout._replace(input_grad=True)
    dx = hg.encode_backward(with_dx, table, x, g, False, True)[1]
    dx_cpu = hg.encode_backward(with_dx, table.cpu(), x.cpu(), g.cpu(), False,
                                True)[1]
    dx_err = (dx.cpu() - dx_cpu).abs()
    dx_rel = float((dx_err.amax(0) / dx_cpu.abs().amax(0)).max())
    res["dx_ms"] = cuda_ms(lambda: hg.encode_backward(
        with_dx, table, x, g, True, True), XLA_REPS)
    # the contributions alone through one index_add_
    idx, w = hg._indices_weights(layout, x)
    u = (w.reshape(n, L, -1, 1) * g.reshape(n, L, 1, F)).reshape(-1, F)
    ids = idx.reshape(-1)
    flat = torch.zeros(rows, F, device="cuda")
    res["library_ms"] = cuda_ms(lambda: flat.index_add_(0, ids, u), XLA_REPS)
    res["sort_ms"] = cuda_ms(lambda: torch.sort(ids, stable=True), XLA_REPS)
    del idx, w, u, ids, flat
    res["brick_fwd_ms"] = cuda_ms(
        lambda: hk.brick_hash_encode(blayout, btable, x), 20)
    res["brick_bwd_ms"] = cuda_ms(
        lambda: hk.brick_hash_encode_bwd(blayout, x, g), 20)
    res.update({f"bwd_{k}": v for k, v in bound(
        nbytes(x, g) + rows * F * 4, n * L * 8 * 2 * F, "f32").items()})
    print(f"xla input gradient vs the CPU's f32 run, {tag}: max err / column "
          f"max |dx| {dx_rel:.2e} (<= {XLA_DX_TOL}), max |dx| "
          f"{float(dx_cpu.abs().max()):.3e} | backward: table "
          f"{res['bwd_ms']:.4f} ms, with the input gradient "
          f"{res['dx_ms']:.4f} ms, bound {res['bwd_bound_ms']:.4f} ms by "
          f"{res['bwd_bound_by']}; one index_add_ of its "
          f"{n * L * 8 * F:,} contributions {res['library_ms']:.4f} ms "
          f"({res['library_ms'] / res['bwd_ms']:.0%} of the backward), a "
          f"sort of their {n * L * 8:,} rows (the JAX sorted_bwd order) "
          f"{res['sort_ms']:.4f} ms more; the brick kernels on these points: "
          f"#6 {res['brick_fwd_ms']:.4f} ms, #7 {res['brick_bwd_ms']:.4f} ms")
    if dx_rel > XLA_DX_TOL or not bool(torch.isfinite(dx).all()):
        fail(f"the xla input gradient disagrees with the CPU, {tag}")
    return res


def xla_eval(arm: dict, views) -> dict:
    """Phase 11 (c): ``run_evaluate`` of views 0 and 4 from the xla arm's
    checkpoint, densely, through the nn.Module, the images those of the
    trained network's last eval bit for bit; one profiled frame."""
    from nerf_replication_tpu_torch.config import make_cfg, parse_args
    from nerf_replication_tpu_torch.models.nerf.renderer import RenderSettings
    from nerf_replication_tpu_torch.run import (
        build_renderer,
        load_model,
        run_evaluate,
    )

    cfg = make_cfg(parse_args([
        "--type", "evaluate", "--cfg_file", "configs/nerf/hard_ngp.yaml",
        *XLA_OPTS, "trained_model_dir", arm["model_dir"],
        "save_result", "False",
        "device", "cuda"]))
    H, W = int(views[0]["H"]), int(views[0]["W"])
    calls = 2 * math.ceil(H * W / RenderSettings.from_cfg(cfg).ray_chunk)
    reset_counts()
    res = run_evaluate(cfg, loader=views)
    counts = read_counts()
    renderer = build_renderer(cfg, load_model(cfg, torch.device("cuda")))
    frame = profile_reading(lambda: renderer.render(views[0]), 1, "frame",
                            "ngp_xla_frame", warm=1)
    del renderer
    same = all(np.array_equal(a, b) for a, b in zip(res["rgb"],
                                                    arm["images"]))
    print(f"xla NGP eval from {cfg.trained_model_dir}: PSNR "
          f"{res['psnr']:.4f} dB (the trained arm's last eval "
          f"{arm['eval_psnr']:.4f}; images bit-equal {same}), SSIM "
          f"{res['ssim']:.4f}, frame times "
          f"{[round(t, 4) for t in res['net_time']]} s, counts {counts}; one "
          f"profiled frame: device busy {frame['busy_ms']:.2f} ms of "
          f"{frame['wall_ms']:.2f} ms (idle {frame['idle']:.1%})")
    expect = dict.fromkeys(counts, 0) | {
        "module": calls * len(views), "mlp": calls * len(views),
        "xla_encode": calls * len(views)}
    if counts != expect:
        fail(f"the xla eval did not run the nn.Module alone: {counts}")
    if not same:
        fail("the xla eval from the checkpoint renders other images than "
             "the trained network")
    return {"psnr": res["psnr"], "net_time": res["net_time"], **frame}


def composite_inputs(name: str, seed: int) -> torch.Tensor:
    """COMPOSITE_POINTS points inside the bounds, and for the timed
    encoders frames 0, 1, 2 and fractional times; float64 values that
    float32 represents exactly."""
    g = np.random.default_rng(seed)
    x = g.uniform(-0.9, 0.9, (COMPOSITE_POINTS, 3))
    if not name.endswith("triplane"):
        t = g.choice([0.0, 1.0, 2.0, 0.5, 1.7], COMPOSITE_POINTS)
        x = np.concatenate([x, t[:, None]], -1)
    return torch.from_numpy(x.astype(np.float32).astype(np.float64))


def rel_norm(a: torch.Tensor, ref: torch.Tensor) -> float:
    """|a - ref| / |ref| in float64, Frobenius norms."""
    ref = ref.double()
    return float((a.double() - ref).norm() / ref.norm().clamp_min(1e-300))


def run_composite(enc, x, cot) -> dict:
    """Forward and backward of ``enc``: the output, every parameter's
    gradient and the points'."""
    enc.zero_grad(set_to_none=True)
    x = x.clone().requires_grad_(True)
    out = enc(x)
    (out * cot).sum().backward()
    res = {"out": out.detach(), "x": x.grad}
    res.update({k: p.grad if p.grad is not None else torch.zeros_like(p)
                for k, p in enc.named_parameters()})
    return res


def composites_against_cpu() -> dict:
    """Phase 11 (d): each composite encoder at the reference's defaults
    (16 levels, log2_hashmap_size 19; dnerf W 256, D 8; 3 frames) on
    COMPOSITE_POINTS seeded points: the card against the CPU in float64
    and in float32 (gated), the card's float32 run against its float64
    one (reported)."""
    import copy

    from nerf_replication_tpu_torch.config import CN
    from nerf_replication_tpu_torch.models.encoding import get_encoder

    res = {}
    for i, name in enumerate(COMPOSITES):
        enc = get_encoder(CN({"type": name, "num_frames": 3,
                              "bounds": [-1.0] * 3 + [1.0] * 3}),
                          torch.Generator().manual_seed(i))
        x = composite_inputs(name, i)
        cot = torch.from_numpy(np.random.default_rng(100 + i).normal(
            size=(x.shape[0], enc.output_dim)))
        card = copy.deepcopy(enc).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f32 = run_composite(card, x.float().cuda(), cot.float().cuda())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        cpu32 = run_composite(enc, x.float(), cot.float())
        on_card = run_composite(card.double(), x.cuda(), cot.cuda())
        on_cpu = run_composite(enc.double(), x, cot)
        worst, f32_cpu, f32_rel, cpu_rel = {}, {}, {}, {}
        for key, ref in on_cpu.items():
            top = float(ref.abs().max())
            worst[key] = float((on_card[key].cpu() - ref).abs().max()) / max(
                top, 1e-300)
            f32_cpu[key] = rel_norm(f32[key].cpu(), cpu32[key])
            f32_rel[key] = rel_norm(f32[key], on_card[key])
            cpu_rel[key] = rel_norm(cpu32[key], ref)
        key = max(worst, key=worst.get)
        tol64 = (COMPOSITE_F64_WARP_TOL if name in COMPOSITE_WARPS
                 else COMPOSITE_F64_TOL)
        if name in COMPOSITE_WARPS:
            # each leaf's f32 gap, card to CPU, against the CPU's own
            # f32 error
            scaled = {k: v / max(cpu_rel[k], 1e-300)
                      for k, v in f32_cpu.items()}
            tol32 = COMPOSITE_F32_WARP_TOL
        else:
            scaled, tol32 = f32_cpu, COMPOSITE_F32_TOL
        key32 = max(scaled, key=scaled.get)
        ok = (max(worst.values()) <= tol64
              and scaled[key32] <= tol32 and all(
                  bool(torch.isfinite(v).all()) for v in f32.values()))
        res[name] = dict(worst=worst[key], ms=ms, leaves=len(worst),
                         f32_cpu=f32_cpu[key32], f32_gate=scaled[key32],
                         f32_out=f32_rel["out"],
                         f32_worst=max(f32_rel.values()))
        gate = ("/ the CPU's f32 error" if name in COMPOSITE_WARPS else "")
        print(f"composite {name}: {sum(p.numel() for p in enc.parameters()):,}"
              f" parameters, output {tuple(on_cpu['out'].shape)}; card vs CPU "
              f"in f64, worst of {len(worst)} (output, points, parameter "
              f"gradients) max err / its max {worst[key]:.2e} ({key}; <= "
              f"{tol64}) | card vs CPU in f32, rel-norm: output "
              f"{f32_cpu['out']:.2e}, worst leaf {gate} {scaled[key32]:.2e} "
              f"({key32}: {f32_cpu[key32]:.2e}, the CPU's f32 error "
              f"{cpu_rel[key32]:.2e}; <= {tol32}) | f32 vs f64 (not "
              f"gated), rel-norm, card / CPU: output {f32_rel['out']:.2e} / "
              f"{cpu_rel['out']:.2e}, worst leaf {max(f32_rel.values()):.2e}"
              f" / {max(cpu_rel.values()):.2e} | f32 forward + backward "
              f"{ms:.1f} ms (one call)")
        if not ok:
            fail(f"the composite encoder {name} disagrees with the CPU")
        del enc, card, f32, cpu32, on_card, on_cpu
        torch.cuda.empty_cache()
    return res


def phase_xla(arrays, views, steps: int, brick_evals: dict) -> dict:
    """Phase 11: the xla encode against the CPU (a), 2000 training steps of
    hard_ngp.yaml on the xla grid (b), the dense eval of its checkpoint
    (c), the composite encoders against the CPU (d)."""
    t0 = time.perf_counter()
    encode = xla_encode_against_cpu(arrays, views)
    t1 = time.perf_counter()
    arm = ngp_train_arm(False, arrays, views, steps, label="xla",
                        extra=XLA_OPTS)
    expect = dict.fromkeys(arm["counts"], 0) | {
        "module": 2 * steps, "mlp": 2 * steps, "xla_encode": 2 * steps}
    if arm["counts"] != expect or arm["steps"] != steps:
        fail(f"the xla arm did not train through the nn.Module alone: "
             f"{arm['counts']}")
    if not np.isfinite(arm["losses"]).all():
        fail("an xla training loss is not finite")
    print(f"xla arm against phase 7's brick arm (other grids; not gated), "
          f"eval PSNR by step: xla "
          f"{ {s: round(db, 4) for s, db in arm['evals'].items()} }, brick "
          f"{ {s: round(db, 4) for s, db in brick_evals.items()} }")
    if arm["eval_psnr"] < NGP_TRAIN_PSNR_FLOOR_DB:
        fail(f"xla NGP eval PSNR {arm['eval_psnr']:.4f} dB below the floor "
             f"{NGP_TRAIN_PSNR_FLOOR_DB} dB")
    if not ngp_checkpoint_round_trip(arm, views[0]):
        fail("the xla checkpoint does not give back the trained state")
    del arm["trainer"]
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    evaluated = xla_eval(arm, views)
    t3 = time.perf_counter()
    composites = composites_against_cpu()
    print(f"phase 11 took {time.perf_counter() - t0:.0f} s: (a) {t1 - t0:.0f},"
          f" (b) {t2 - t1:.0f}, (c) {t3 - t2:.0f}, (d) "
          f"{time.perf_counter() - t3:.0f}")
    return {"encode": encode, "calls": arm["counts"]["xla_encode"],
            "eval": evaluated, "composites": composites}


# Phase 12: the host loader. (a) img_fit as committed, from the JAX init
# data/pretrain/img_fit_init (written by scripts/img_fit_jax_reference.py),
# whose reading of the same run on the CPU (the JAX package's own
# generate_scene, init, dataset seed and 1000 steps) is the gate's target.
IMG_FIT_ARGV = ["--cfg_file", "configs/img_fit/lego_view0.yaml", "scene",
                "hard", "device", "cuda", "resume", "False", "pretrain",
                "data/pretrain/img_fit_init", "eval_ep", "1"]
IMG_FIT_EPOCHS = 2
IMG_FIT_DATA_SEED = 0
IMG_FIT_SIZE = 800            # the lego view's size
# eval PSNR at the ends of epochs 1 and 2 (scripts/img_fit_jax_reference.py)
IMG_FIT_JAX_PSNR_DB = (25.864508824931885, 28.03621272812383)
IMG_FIT_GATE_DB = 0.2
HOST_STEPS = 200              # (b): host-loader steps of the NeRF model
HOST_PROFILE_STEPS = 20


def host_step_fn(trainer, loader):
    """One more host-loader step a call: the next batch to the device and
    through the trainer's step (for the profiled window)."""
    from nerf_replication_tpu_torch.train.trainers.trainer import (
        host_batch_to_device,
    )

    batches = iter(loader)
    gen = torch.Generator(device="cuda").manual_seed(1)
    return lambda: trainer.train_step(
        host_batch_to_device(next(batches), trainer.device), gen)


def host_loader_img_fit(profile: bool) -> dict:
    """Phase 12 (a): configs/img_fit/lego_view0.yaml through ``train()``
    and the host loader on one 800x800 view of the hard scene written by
    ``generate_scene`` on the card, 2 epochs of 500 steps from the JAX
    init; the epoch-2 eval PSNR within IMG_FIT_GATE_DB of the JAX
    package's CPU reading; no kernel launched."""
    from nerf_replication_tpu_torch.config import make_cfg, parse_args
    from nerf_replication_tpu_torch.datasets import make_data_loader
    from nerf_replication_tpu_torch.train.cli import train
    from nerf_replication_tpu_torch.utils import synthetic_scene

    root = os.path.join(ROOT, "build", "smoke_img_fit")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    synthetic_scene.generate_scene(root, "hard", H=IMG_FIT_SIZE,
                                   W=IMG_FIT_SIZE, n_train=1, n_val=0,
                                   n_test=0, device="cuda")
    print(f"img_fit scene: one {IMG_FIT_SIZE}x{IMG_FIT_SIZE} hard view "
          f"written by generate_scene in {time.perf_counter() - t0:.1f} s")
    cfg = make_cfg(parse_args(IMG_FIT_ARGV + [
        "train_dataset.data_root", root, "test_dataset.data_root", root,
        "train.epoch", str(IMG_FIT_EPOCHS),
        "trained_model_dir", os.path.join(root, "model"),
        "record_dir", os.path.join(root, "record"),
        "result_dir", os.path.join(root, "result")]))
    cfg.train_dataset.seed = IMG_FIT_DATA_SEED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    trainer = train(cfg)
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    psnrs = [e["psnr"] for e in trainer.evals]
    s = trainer.summaries
    data_share = sum(float(x["data_time"].sum()) for x in s) / sum(
        x["wall"] for x in s)
    res = dict(psnrs=psnrs, pixels_per_s=[x["rays_per_s"] for x in s],
               data_share=data_share, peak_gb=peak_gb, counts=counts)
    print(f"img_fit (host loader): {trainer.step} steps of "
          f"{s[-1]['rows']} pixels, eval PSNR by epoch "
          f"{[round(p, 4) for p in psnrs]} dB (JAX package on the CPU "
          f"{list(IMG_FIT_JAX_PSNR_DB)}), pixels/s by epoch "
          f"{[round(r) for r in res['pixels_per_s']]}, data_time "
          f"{100 * data_share:.1f}% of the wall, peak memory "
          f"{peak_gb:.3f} GB, counts {counts}")
    if len(psnrs) != IMG_FIT_EPOCHS or not np.isfinite(psnrs).all():
        fail(f"img_fit gave no finite eval PSNR each epoch: {psnrs}")
    if any(counts.values()):
        fail(f"img_fit ran a kernel or a NeRF module: {counts}")
    if abs(psnrs[-1] - IMG_FIT_JAX_PSNR_DB[-1]) > IMG_FIT_GATE_DB:
        fail(f"img_fit epoch-2 PSNR {psnrs[-1]:.4f} dB is not within "
             f"{IMG_FIT_GATE_DB} dB of the JAX package's "
             f"{IMG_FIT_JAX_PSNR_DB[-1]:.4f} dB")
    if profile:
        loader = make_data_loader(cfg, is_train=True, max_iter=1 << 20)
        res["profile"] = profile_reading(
            host_step_fn(trainer, loader), HOST_PROFILE_STEPS, "step",
            "host_loader_img_fit")
    return res


def host_loader_nerf(arrays, profile: bool) -> dict:
    """Phase 12 (b): configs/nerf/hard.yaml through ``Trainer.train`` over
    a host loader on phase 5's 20 train views, built as a Blender train
    split (``Dataset.from_arrays``: each item draws N_rays pixels of one
    view): the first host batch's loss and leaf gradients through the
    kernels against the nn.Module arm (phase 10 (f)'s bounds), then
    HOST_STEPS steps from the seed-0 init: 2 launches of #3/#4 and 2 of #5
    a step as in phase 5, no plain call, a finite loss."""
    from nerf_replication_tpu_torch.config import make_cfg, parse_args
    from nerf_replication_tpu_torch.datasets import make_loader
    from nerf_replication_tpu_torch.datasets.nerf.blender import Dataset
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.train import make_recorder, make_trainer
    from nerf_replication_tpu_torch.train.trainers.trainer import (
        host_batch_to_device,
    )
    from nerf_replication_tpu_torch.utils import synthetic_scene

    cfg = make_cfg(parse_args(TRAIN_ARGV + ["ep_iter", str(HOST_STEPS),
                                            "log_interval", "50"]))
    images, poses = arrays[0], arrays[1]

    def loader():
        split = Dataset.from_arrays(cfg, images, poses,
                                    synthetic_scene.CAMERA_ANGLE_X, seed=0)
        return make_loader(cfg, split, is_train=True, max_iter=HOST_STEPS)

    batch = host_batch_to_device(next(iter(loader())), torch.device("cuda"))
    arms = {}
    for fused in (True, False):
        cfg_arm = cfg.clone()
        cfg_arm.network.use_pallas_mlp_train = fused
        net = make_network(cfg_arm).cuda()
        wrapper = make_trainer(cfg_arm, net).wrapper
        gen = torch.Generator(device="cuda").manual_seed(0)
        reset_counts()
        loss, _ = wrapper.loss_fn(batch, gen, train=True)
        loss.backward()
        torch.cuda.synchronize()
        arms[fused] = (float(loss.detach()), torch.cat(
            [p.grad.ravel() for _, p in net.named_parameters()]),
            read_counts())
    (loss_k, grad_k, first), (loss_m, grad_m, _) = arms[True], arms[False]
    loss_rel = abs(loss_k - loss_m) / abs(loss_m)
    grad_rel = float((grad_k - grad_m).norm() / grad_m.norm())
    print(f"host batch ({batch['rays_o'].shape[0]} x "
          f"{batch['rays_o'].shape[1]} rays), kernels against nn.Module: "
          f"loss {loss_k:.6f} / {loss_m:.6f} (rel {loss_rel:.2e} <= "
          f"{ARMS_LOSS_REL}), all leaves rel-norm {grad_rel:.2e} (<= "
          f"{ARMS_GRAD_REL}); the kernel arm's counts {first}")
    if (first["fwd"], first["bwd"], first["plain"], first["module"]) != \
            (2, 2, 0, 0):
        fail(f"the host batch did not run through #3-#5 alone: {first}")
    if loss_rel > ARMS_LOSS_REL or grad_rel > ARMS_GRAD_REL:
        fail("the host batch's kernel arm disagrees with the nn.Module arm")

    net = make_network(cfg).cuda()
    trainer = make_trainer(cfg, net)
    trainer.wrapper.renderer.train_apply   # builds the kernels now
    recorder = make_recorder(cfg)
    torch.cuda.synchronize()
    reset_counts()
    summary = trainer.train(0, loader(), recorder)
    counts = read_counts()
    steps = summary["steps"]
    data_share = float(summary["data_time"].sum()) / summary["wall"]
    res = dict(steps=steps, counts=counts, steps_per_s=steps / summary["wall"],
               rays_per_s=summary["rays_per_s"], data_share=data_share,
               loss=summary["loss"])
    print(f"NeRF (host loader): {steps} steps in {summary['wall']:.2f} s, "
          f"{res['steps_per_s']:.2f} steps/s ({summary['rays_per_s']:,.0f} "
          f"rays/s; phase 5's train_device above), data_time "
          f"{100 * data_share:.1f}% of the wall, loss first/last "
          f"{summary['loss'][0]:.5f} / {summary['loss'][-1]:.5f}, counts "
          f"{counts}")
    if (counts["fwd"], counts["bwd"], counts["plain"], counts["module"]) != \
            (2 * steps, 2 * steps, 0, 0):
        fail(f"the host-loader run did not train through #3-#5 alone: "
             f"{counts}")
    if not np.isfinite(summary["loss"]).all():
        fail("the host-loader run's loss is not finite")
    if profile:
        res["profile"] = profile_reading(
            host_step_fn(trainer, make_loader(
                cfg, Dataset.from_arrays(cfg, images, poses,
                                         synthetic_scene.CAMERA_ANGLE_X,
                                         seed=1),
                is_train=True, max_iter=1 << 20)),
            HOST_PROFILE_STEPS, "step", "host_loader_nerf")
    return res


def phase_host_loader(arrays, profile: bool) -> dict:
    """Phase 12: (a) img_fit and (b) the NeRF model through the host
    loader; (c) with ``--profile``, a profiled window of 20 host-loader
    steps of each."""
    t0 = time.perf_counter()
    img_fit = host_loader_img_fit(profile)
    torch.cuda.empty_cache()
    nerf = host_loader_nerf(arrays, profile)
    torch.cuda.empty_cache()
    print(f"phase 12 took {time.perf_counter() - t0:.0f} s")
    return {"img_fit": img_fit, "nerf": nerf}


# -- phase 13: data parallel on the card ---------------------------------

# Phase 13's bounds. (a) One rank over nccl must be bit-equal to a process
# without a group. (b) N ranks against one process: the per-step losses of
# the first DP_FIRST_STEPS steps within the dry run's rtol 1e-4 and all
# DP_STEPS within DP_LOSS_RTOL (stated in PERF.md section 6 from this
# phase's readings); the faulty ranks of DP_CONTROLS must miss them. The
# NGP table gradient after the all-reduce within #7's own atomic-order
# bound, BRICK_BWD_TOL of a level's max |gradient|; the dense eval within
# the JAX test's floor (> 90% of pixels bit-equal, atol 5e-4); the frames
# within the JAX tests' bounds (compacted: < 5% of pixels off by more than
# 1e-3, max < 2e-2; NGP: atol 1e-5).
DP_STEPS = 20
DP_FIRST_STEPS = 2
DP_FIRST_RTOL = 1e-4
DP_LOSS_RTOL = 2e-4     # read 1.80e-5 (2 ranks on the H100); controls >= 2.4e-2
# hard.yaml's first-step gradients after the all-reduce against one
# process's: the worst tensor's largest difference over its largest
# magnitude (parallel.dryrun.grad_rel); read 4.65e-7 (2 ranks on the H100),
# controls 1.00 (sum without division) and 0.190 (own draws)
DP_GRAD_TOL = 1e-5
DP_CONTROLS = ("sum without division", "own draws")
DP_EVAL_ATOL = 5e-4
DP_EVAL_BIT_EQUAL = 0.9
DP_COMPACT_OFF, DP_COMPACT_MAX = (1e-3, 0.05), 2e-2
DP_NGP_ATOL = 1e-5
DP_RANKS_TIMEOUT_S = 420       # a group's whole run, or every rank is killed
DP_COLLECTIVE_TIMEOUT_S = 180
DP_DIR = os.path.join(ROOT, "build", "dp")
DP_EVAL_ARGV = ["--type", "evaluate", "--cfg_file", "configs/nerf/hard.yaml",
                "pretrain_path", "data/pretrain/hard", "save_result",
                "False", "device", "cuda"]


def dp_train(argv, arrays, mesh, steps: int,
             control: str | None = None) -> dict:
    """``steps`` training steps of ``argv``'s config from its seed-0 init on
    ``arrays``, data-parallel over ``mesh`` (or in this process alone),
    through ``Trainer.train_device``: one step, then the rest timed.
    ``control`` names a faulty rank of ``parallel.dryrun.CONTROLS``.
    Returns the per-step losses, the parameters (on the host), the first
    step's gradients as the optimizer takes them (after the all-reduce,
    before the clip) and, for a hash grid, its table's (after the clip),
    the seconds a step after the first and the launch counts."""
    from nerf_replication_tpu_torch.config import make_cfg, parse_args
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.parallel.dryrun import (
        control_mesh,
        record_first_grads,
    )
    from nerf_replication_tpu_torch.train import make_trainer
    from nerf_replication_tpu_torch.train.cli import make_pipeline

    cfg = make_cfg(parse_args(argv))
    net = make_network(cfg).cuda()
    if control is not None:
        mesh = control_mesh(mesh, control)
    trainer = make_trainer(cfg, net, mesh=mesh)
    grads = record_first_grads(trainer)
    trainer.wrapper.renderer.train_apply   # builds the kernels now
    pipeline = make_pipeline(cfg, arrays, "cuda")
    with contextlib.redirect_stdout(io.StringIO()):
        reset_counts()
        first = trainer.train_device(0, pipeline, n_steps=1)
        table = getattr(net.xyz_encoder, "table", None)
        grad = None if table is None else table.grad.detach().clone()
        rest = trainer.train_device(1, pipeline, n_steps=steps - 1)
        counts = read_counts()
    return {"losses": np.concatenate([first["loss"], rest["loss"]]),
            "params": {k: v.detach().cpu() for k, v in
                       net.state_dict().items()},
            "grads": [g.cpu() for g in grads], "grad": grad,
            "step_s": rest["wall"] / (steps - 1),
            "counts": counts,
            "layout": getattr(net.xyz_encoder, "layout", None)}


def dp_frames(spec: dict, mesh) -> dict:
    """The compacted ERT frame (data/pretrain/hard through #1, phase 10's
    grid and budgets, 2 segments) and the NGP frame-path frame
    (data/pretrain/hard_ngp_b9 through #10's f32 arm, phase 9's grids,
    step, budgets and probe) of orbit pose 0, float32, sharded over
    ``mesh`` or rendered alone, with each one's launch counts."""
    from nerf_replication_tpu_torch import raymarch_bench as rb
    from nerf_replication_tpu_torch.config import make_cfg, parse_args
    from nerf_replication_tpu_torch.models.nerf.renderer import (
        Renderer,
        ngp_renderer,
    )
    from nerf_replication_tpu_torch.run import build_renderer, load_model

    H, W, focal = spec["H"], spec["W"], spec["focal"]
    pose = torch.as_tensor(rb.orbit_poses(FRAME_WINDOW)[0], device="cuda")
    out = {}
    cfg = make_cfg(parse_args(DP_EVAL_ARGV))
    base = build_renderer(cfg, load_model(cfg, torch.device("cuda")))
    c = spec["compact"]
    fn = Renderer(base.net, settings=dataclasses.replace(
        base.settings, ert_segments=2), mesh=mesh).use_apply(
            base.apply_fn).make_frame_renderer(
        H, W, focal, capacity=c["caps"][0], coarse_capacity=c["caps"][1],
        occupancy=c["occupancy"], out_dtype=torch.float32)
    reset_counts()
    out["compact"] = fn(pose)
    out["compact_counts"] = read_counts()
    n = spec["ngp"]
    cfg = make_cfg(parse_args(NGP_ARGV))
    apply_fn = ngp_renderer.make_ngp_eval_apply(
        load_model(cfg, torch.device("cuda")))
    C, M, F = n["step"]
    fn = ngp_renderer.make_ngp_frame_renderer(
        apply_fn, H, W, focal, n["occupancy"], n["settings"],
        n_candidates=C, n_coarse=M, n_fine=F, capacity=n["caps"]["capacity"],
        fine_capacity=n["caps"]["fine"], occ_capacity=n["caps"]["occ"],
        select_occupancy=n["select"], probe_sub=n["probe"][0],
        probe_stride=n["probe"][1], out_dtype=torch.float32, mesh=mesh)
    reset_counts()
    out["ngp"] = fn(pose)
    out["ngp_counts"] = read_counts()
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dp_env(rank: int, size: int, port: int) -> dict:
    return {"RANK": str(rank), "LOCAL_RANK": str(rank),
            "WORLD_SIZE": str(size), "LOCAL_WORLD_SIZE": str(size),
            "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}


def run_ranks(n: int, args: list, tag: str, per_rank_env: bool = True
              ) -> list[str]:
    """``python3 *args`` as ``n`` ranks (or, without ``per_rank_env``, one
    launcher process), all started together; every one is killed if one
    fails or the group outlives DP_RANKS_TIMEOUT_S, and the phase fails.
    Returns each process's output."""
    port = _free_port()
    base = {"OMP_NUM_THREADS": "1", **os.environ}   # as torchrun sets it
    envs = ([{**base, **_dp_env(r, n, port)} for r in range(n)]
            if per_rank_env else [base])
    procs = [subprocess.Popen([sys.executable, *args], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for env in envs]
    deadline = time.monotonic() + DP_RANKS_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        logs = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if logs is None:
        fail(f"{tag}: the ranks outlived {DP_RANKS_TIMEOUT_S} s")
    bad = [(r, p.returncode, log) for r, (p, log) in
           enumerate(zip(procs, logs)) if p.returncode]
    for r, rc, log in bad:
        print(f"{tag}: process {r} exited {rc}; its output ends:\n"
              f"{log[-3000:]}")
    if bad:
        fail(f"{tag}: {len(bad)} of {len(procs)} processes failed")
    return logs


def dp_rank_main(plan_dir: str):
    """One rank of phase 13 (``chip_smoke.py --dp_rank DIR``, its
    ``RANK`` / ``WORLD_SIZE`` / ``MASTER_*`` set by the parent): the
    data-parallel training runs, the sharded dense eval through ``run
    --type evaluate``'s ``run_evaluate`` and the sharded frames, with each
    one's launches on this rank; writes ``rank<r>.json`` and rank 0 the
    tensors the parent compares."""
    from nerf_replication_tpu_torch.config import make_cfg, parse_args
    from nerf_replication_tpu_torch.parallel.mesh import make_mesh
    from nerf_replication_tpu_torch.run import run_evaluate

    os.chdir(ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # make_mesh's rule gives the parent's backend: gloo where the ranks
    # outnumber the cards, else nccl
    mesh = make_mesh(device="cuda", timeout_s=DP_COLLECTIVE_TIMEOUT_S)
    plan = torch.load(os.path.join(plan_dir, "plan.pt"),
                      map_location=mesh.device, weights_only=False)
    arrays = tuple(np.load(os.path.join(plan_dir, f"{k}.npy"))
                   for k in ("images", "poses", "K", "alphas"))
    out, tensors = {"rank": mesh.rank, "size": mesh.size,
                    "backend": mesh.backend}, {}
    for name, argv in (("hard", TRAIN_ARGV), ("ngp", NGP_TRAIN_ARGV)):
        run = dp_train(argv, arrays, mesh, DP_STEPS)
        out[name] = {"losses": run["losses"].tolist(),
                     "step_s": run["step_s"], "counts": run["counts"]}
        tensors[f"{name}_params"] = run["params"]
        if run["grad"] is not None:
            tensors[f"{name}_grad"] = run["grad"].cpu()
        else:
            tensors[f"{name}_grads"] = dict(enumerate(run["grads"]))
    out["controls"] = {}
    for c in DP_CONTROLS:
        run = dp_train(TRAIN_ARGV, arrays, mesh, DP_STEPS, control=c)
        out["controls"][c] = run["losses"].tolist()
        tensors[f"control {c} grads"] = dict(enumerate(run["grads"]))
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        res = run_evaluate(make_cfg(parse_args(DP_EVAL_ARGV)),
                           loader=[plan["view0"]])
    out["eval"] = {"counts": read_counts(), "net_time": res["net_time"]}
    tensors["eval"] = torch.from_numpy(res["rgb"][0])
    frames = dp_frames(plan["frames"], mesh)
    for key in ("compact", "ngp"):
        tensors[key] = frames[key].cpu()
        out[f"{key}_counts"] = frames[f"{key}_counts"]
    if mesh.is_main:
        torch.save(tensors, os.path.join(plan_dir, "rank0.pt"))
    # every rank's own checksum of what rank 0 saved: all ranks hold the
    # same parameters, gradient, image and frames
    out["sums"] = {k: float(sum(t.double().abs().sum() for t in v.values())
                            if isinstance(v, dict) else v.double().abs().sum())
                   for k, v in tensors.items()}
    with open(os.path.join(plan_dir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def _loss_rel(losses, ref) -> np.ndarray:
    return np.abs(np.asarray(losses) - ref) / np.abs(ref)


def _params_diff(a: dict, b: dict) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in b
               if b[k].is_floating_point())


def _dp_losses_ok(losses, ref) -> tuple[bool, float, float]:
    rel = _loss_rel(losses, ref)
    first, whole = float(rel[:DP_FIRST_STEPS].max()), float(rel.max())
    return (first <= DP_FIRST_RTOL and whole <= DP_LOSS_RTOL), first, whole


def phase_dp(arrays, views, dense: dict, frame_specs: dict) -> dict:
    """Phase 13: data parallel on the card. (a) One rank over nccl in this
    process, bit-equal to no group. (b) N ranks as processes: 2 sharing the
    one card over gloo, or nccl over min(count, 4) cards; the frequency
    and NGP training against one process, two faulty controls, the dense
    eval of view 0 against phase 3's, the frames against one rank's, each
    kernel's launches a rank. (c) The dry run on 2 ranks. Returns the
    readings."""
    import torch.distributed as dist

    from nerf_replication_tpu_torch.config import make_cfg, parse_args
    from nerf_replication_tpu_torch.models.nerf.renderer import (
        RenderSettings,
    )
    from nerf_replication_tpu_torch.parallel.dryrun import grad_rel
    from nerf_replication_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    ref = dp_train(TRAIN_ARGV, arrays, None, DP_STEPS)
    saved = {k: os.environ.get(k) for k in _dp_env(0, 1, 0)}
    os.environ.update(_dp_env(0, 1, _free_port()))
    try:
        one = dp_train(TRAIN_ARGV, arrays, make_mesh(
            device="cuda", backend="nccl",
            timeout_s=DP_COLLECTIVE_TIMEOUT_S), DP_STEPS)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    same = bool(np.array_equal(one["losses"], ref["losses"])) and all(
        torch.equal(one["params"][k], v) for k, v in ref["params"].items())
    print(f"data parallel (a): 1 rank over nccl against no group, "
          f"{DP_STEPS} steps of hard.yaml through #3-#5: losses and "
          f"parameters {'bit-equal' if same else 'DIFFER'} (max loss diff "
          f"{float(np.abs(one['losses'] - ref['losses']).max()):.2e}, "
          f"parameters {_params_diff(one['params'], ref['params']):.2e}); "
          f"{ref['step_s'] * 1e3:.2f} / {one['step_s'] * 1e3:.2f} ms a step; "
          f"counts {one['counts']}")
    if not same:
        fail("one rank over nccl is not bit-equal to a process without a "
             "group")
    ref_ngp = dp_train(NGP_TRAIN_ARGV, arrays, None, DP_STEPS)
    ref_frames = dp_frames(frame_specs, None)

    count = torch.cuda.device_count()
    n = 2 if count == 1 else min(count, 4)
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(f"data parallel: {count} card(s): {' | '.join(cards)}")
    shutil.rmtree(DP_DIR, ignore_errors=True)
    os.makedirs(DP_DIR)
    for k, a in zip(("images", "poses", "K", "alphas"), arrays):
        a = np.asarray(a)
        if k in ("images", "alphas"):   # as the pipeline stores them
            a = np.round(np.clip(a, 0.0, 1.0) * 255.0).astype(np.uint8)
        np.save(os.path.join(DP_DIR, f"{k}.npy"), a)
    torch.save({"view0": views[0], "frames": frame_specs},
               os.path.join(DP_DIR, "plan.pt"))
    t1 = time.perf_counter()
    run_ranks(n, [os.path.join(ROOT, "chip_smoke.py"), "--dp_rank", DP_DIR],
              "data parallel (b)")
    ranks_s = time.perf_counter() - t1
    res = []
    for r in range(n):
        with open(os.path.join(DP_DIR, f"rank{r}.json")) as f:
            res.append(json.load(f))
    got = torch.load(os.path.join(DP_DIR, "rank0.pt"), weights_only=False)
    r0 = res[0]
    print(f"data parallel (b): {n} ranks over {r0['backend']} "
          f"({'sharing the one card' if count == 1 else f'{n} cards'}), "
          f"{ranks_s:.1f} s for the group's run")
    if any(r["sums"] != r0["sums"] for r in res):
        fail("the ranks do not hold the same parameters, gradient and "
             "images")
    readings = {"ranks": n, "backend": r0["backend"]}
    if r0["backend"] != ("gloo" if count == 1 else "nccl"):
        fail(f"data parallel (b): {n} ranks on {count} cards took "
             f"{r0['backend']}")
    bad = []

    # training: the frequency model, the controls, NGP
    ok, first, whole = _dp_losses_ok(r0["hard"]["losses"], ref["losses"])
    gdiff = grad_rel(list(got["hard_grads"].values()), ref["grads"])
    pdiff = _params_diff(got["hard_params"], ref["params"])
    print(f"data parallel (b) hard.yaml, {DP_STEPS} steps at 1024 rays: "
          f"the first step's gradients after the all-reduce against one "
          f"process, worst tensor {gdiff:.2e} of its max (<= {DP_GRAD_TOL});"
          f" per-step losses max rel {first:.2e} over "
          f"the first {DP_FIRST_STEPS} (<= {DP_FIRST_RTOL}), {whole:.2e} "
          f"over {DP_STEPS} (<= {DP_LOSS_RTOL}); max parameter diff "
          f"{pdiff:.2e}; counts a rank {[r['hard']['counts'] for r in res]}")
    bad += [] if ok else ["hard.yaml's per-step losses"]
    bad += [] if gdiff <= DP_GRAD_TOL else ["hard.yaml's first-step gradients"]
    # a control must miss both gates: the gradient one on its own merits
    # (the loss stats ride in the gradients' buffer, so a sum without
    # division misses the loss gate through the doubled stats alone)
    for c, losses in r0["controls"].items():
        c_ok, c_first, c_whole = _dp_losses_ok(losses, ref["losses"])
        c_grad = grad_rel(list(got[f"control {c} grads"].values()),
                          ref["grads"])
        print(f"data parallel (b) control, {c}: first-step gradients "
              f"{c_grad:.2e} of a tensor's max: "
              f"{'ACCEPTED' if c_grad <= DP_GRAD_TOL else 'refused'}; "
              f"losses max rel {c_first:.2e} over the first "
              f"{DP_FIRST_STEPS}, {c_whole:.2e} over {DP_STEPS}: "
              f"{'ACCEPTED' if c_ok else 'refused'}")
        bad += [f"the control {c} passes the loss bounds"] if c_ok else []
        bad += ([f"the control {c} passes the gradient bound"]
                if c_grad <= DP_GRAD_TOL else [])
    ok, first, whole = _dp_losses_ok(r0["ngp"]["losses"], ref_ngp["losses"])
    grad = brick_bwd_agreement(
        ref_ngp["layout"], got["ngp_grad"].cuda(), ref_ngp["grad"].double(),
        torch.ones(ref_ngp["grad"].shape[0], dtype=torch.bool,
                   device="cuda"))
    gerr = grad["levels"]
    print(f"data parallel (b) hard_ngp.yaml, {DP_STEPS} steps through "
          f"#6/#7: the first step's table gradient after the all-reduce "
          f"against one process, worst level {max(gerr):.2e} of its max "
          f"(<= {BRICK_BWD_TOL}); per-step losses max rel {first:.2e} over "
          f"the first {DP_FIRST_STEPS} (<= {DP_FIRST_RTOL}), {whole:.2e} "
          f"over {DP_STEPS} (<= {DP_LOSS_RTOL}; #7's atomics sum in a "
          f"run-dependent order); max parameter diff "
          f"{_params_diff(got['ngp_params'], ref_ngp['params']):.2e}; "
          f"counts a rank {[r['ngp']['counts'] for r in res]}")
    bad += [] if grad["ok"] else ["the NGP table gradient"]
    bad += [] if ok else ["hard_ngp.yaml's per-step losses"]

    # the dense eval, the frames
    img, ref_img = got["eval"].numpy(), np.asarray(dense["rgb"][0])
    bit = float(np.mean(np.all(img == ref_img, axis=-1)))
    ediff = float(np.abs(img - ref_img).max())
    print(f"data parallel (b) dense eval of hard view 0 at "
          f"{views[0]['H']}x{views[0]['W']} (run_evaluate, sharded): "
          f"{100 * bit:.4f}% of pixels bit-equal to phase 3's one-process "
          f"render (> {100 * DP_EVAL_BIT_EQUAL:.0f}%),"
          f" max diff {ediff:.2e} (<= {DP_EVAL_ATOL}); frame "
          f"{r0['eval']['net_time'][0]:.3f} s against "
          f"{dense['net_time'][0]:.3f} s alone; counts a rank "
          f"{[r['eval']['counts'] for r in res]}")
    bad += [] if bit > DP_EVAL_BIT_EQUAL and ediff <= DP_EVAL_ATOL \
        else ["the dense eval"]
    cdiff = (got["compact"] - ref_frames["compact"].cpu()).abs()
    off = float((cdiff > DP_COMPACT_OFF[0]).float().mean())
    gdiff = float((got["ngp"] - ref_frames["ngp"].cpu()).abs().max())
    print(f"data parallel (b) frames of orbit pose 0 against one rank: "
          f"compacted ERT frame max diff {float(cdiff.max()):.2e}, "
          f"{100 * off:.4f}% of pixels off by > {DP_COMPACT_OFF[0]} (< "
          f"{100 * DP_COMPACT_OFF[1]:.0f}%, max < {DP_COMPACT_MAX}); NGP "
          f"frame max diff {gdiff:.2e} (<= {DP_NGP_ATOL})")
    bad += [] if (off < DP_COMPACT_OFF[1] and float(cdiff.max())
                  < DP_COMPACT_MAX) else ["the compacted frame"]
    bad += [] if gdiff <= DP_NGP_ATOL else ["the NGP frame"]

    # each kernel's launches a rank: non-zero on every rank; the training
    # kernels' equal to one process's (2 a step each), the render kernels'
    # summing to one rank's (every chunk rendered once, by one rank)
    chunk = RenderSettings.from_cfg(make_cfg(parse_args(
        DP_EVAL_ARGV))).ray_chunk
    one = {"fused_nerf_mlp_enc": 2 * math.ceil(
               views[0]["H"] * views[0]["W"] / chunk)
           + ref_frames["compact_counts"]["enc"],
           "fused_nerf_mlp": ref["counts"]["fwd"],
           "fused_nerf_mlp_bwd": ref["counts"]["bwd"],
           "brick_hash_encode": ref_ngp["counts"]["brick_fwd"],
           "brick_hash_encode_bwd": ref_ngp["counts"]["brick_bwd"],
           "fused_ngp_eval": ref_frames["ngp_counts"]["ngp"]}
    launches = {
        "fused_nerf_mlp_enc": [r["eval"]["counts"]["enc"]
                               + r["compact_counts"]["enc"] for r in res],
        "fused_nerf_mlp": [r["hard"]["counts"]["fwd"] for r in res],
        "fused_nerf_mlp_bwd": [r["hard"]["counts"]["bwd"] for r in res],
        "brick_hash_encode": [r["ngp"]["counts"]["brick_fwd"] for r in res],
        "brick_hash_encode_bwd": [r["ngp"]["counts"]["brick_bwd"]
                                  for r in res],
        "fused_ngp_eval": [r["ngp_counts"]["ngp"] for r in res]}
    plain = [r[k]["counts"]["plain"] for r in res for k in ("hard", "ngp",
                                                            "eval")]
    print(f"data parallel (b): launches a rank {launches} (one process "
          f"{one}), plain calls {sum(plain)}")
    for name, per_rank in launches.items():
        trains = name in ("fused_nerf_mlp", "fused_nerf_mlp_bwd",
                          "brick_hash_encode", "brick_hash_encode_bwd")
        if min(per_rank) == 0 or (set(per_rank) != {one[name]} if trains
                                  else sum(per_rank) != one[name]):
            bad.append(f"{name}'s launches a rank {per_rank}")
    if sum(plain):
        bad.append(f"{sum(plain)} plain calls on the ranks")
    step = [ref["step_s"], r0["hard"]["step_s"]]
    print(f"data parallel (b) step time, hard.yaml: one process "
          f"{step[0] * 1e3:.2f} ms, {n} ranks {step[1] * 1e3:.2f} ms a step"
          + (" (two processes time-sharing one card: not a scaling figure)"
             if count == 1 else ""))

    # (c) the dry run
    logs = run_ranks(1, ["-m", "torch.distributed.run", "--standalone",
                         "--nproc_per_node=2", "-m",
                         "nerf_replication_tpu_torch.parallel.dryrun"],
                     "data parallel (c)", per_rank_env=False)
    lines = [ln for ln in logs[0].splitlines() if "dryrun_multichip(" in ln]
    print("data parallel (c) dry run on 2 ranks: " + " | ".join(lines))
    if len(lines) != 2:
        bad.append("the dry run's lines")
    if bad:
        fail("data parallel: " + "; ".join(bad))
    print(f"phase 13 took {time.perf_counter() - t0:.0f} s")
    readings.update(launches=launches, step_ms=[s * 1e3 for s in step])
    return readings


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=TRAIN_STEPS,
                        help="training steps per arm (a multiple of 4)")
    parser.add_argument("--profile", type=int, default=0,
                        help="profile this many more steps of each arm "
                             "and of the NGP kernel arm (and 5 fused NGP "
                             "frames)")
    parser.add_argument("--first", metavar="DIR",
                        help="csrc directory of the brick gather kernels' "
                             "first designs, timed beside the present ones")
    parser.add_argument("--dp_rank", metavar="DIR",
                        help="run as one rank of phase 13 (started by "
                             "phase 13 itself, with the plan in DIR)")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    if opts.dp_rank:
        return dp_rank_main(opts.dp_rank)
    from nerf_replication_tpu_torch.config import make_cfg, parse_args
    from nerf_replication_tpu_torch.evaluators import psnr_uint8
    from nerf_replication_tpu_torch.models.nerf.renderer import RenderSettings
    from nerf_replication_tpu_torch.ops import (
        _build,
        fused_ngp,
        mlp_kernel,
        mlp_train,
    )
    from nerf_replication_tpu_torch.run import load_model, run_evaluate
    from nerf_replication_tpu_torch.utils import synthetic_scene, tracing

    os.chdir(ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernel = mlp_kernel.fused_nerf_mlp_enc
    plain = mlp_kernel.fused_nerf_mlp_enc_reference
    # their tracing.counts keys
    kernel_key, plain_key = (f"{kernel.__name__}.launches",
                             f"{plain.__name__}.calls")

    # -- 1. device and build -------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = ["fused_nerf_mlp", "fused_nerf_mlp_bwd", "brick_encode_eval",
            "fused_ngp", "brick_hash_encode", "probe_gather"]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        firsts = pool.submit(build_first_designs, opts.first) \
            if opts.first else None
        _build.build_all(libs)   # one nvcc each, all started together
        if firsts is not None:
            FIRST_DESIGNS.update(firsts.result())
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for lib in libs:
        log = _build.library_path(lib).with_suffix(".log")
        print(f"ptxas {lib}:",
              " | ".join(line.strip() for line in log.read_text().splitlines()
                         if "Used" in line or "spill" in line
                         or "Potential Performance Loss" in line))
    shape, smem = mlp_kernel.launch_shape(POINTS[1]), \
        mlp_train.shared_memory_bytes(8)
    print(f"8x256 MLP kernels: {shape['blocks']} persistent blocks of 128 "
          f"points a tile; dynamic shared "
          f"memory a block: forward {shape['shared_memory_bytes']} B, "
          f"backward delta kernel {smem['delta']} B (depth 8), "
          f"weight-gradient kernel {smem['wgrad']} B (of {SMEM_LIMIT} B)")

    # -- 2. kernel against plain at the render path's point counts --------
    argv = ["--type", "evaluate", "--cfg_file", "configs/nerf/hard.yaml",
            "pretrain_path", "data/pretrain/hard", "save_result", "False",
            "device", "cuda"]
    cfg = make_cfg(parse_args(argv))
    net = load_model(cfg, torch.device("cuda"))
    enc = net.xyz_encoder.output_dim, net.dir_encoder.output_dim
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = {}
    for n in POINTS:
        for branch in ("coarse", "fine"):
            mlp = getattr(net, branch)
            packed = mlp_kernel.pack_nerf_params(
                mlp.state_dict(), *enc, mlp.depth, mlp.skips[0])
            pts, dirs = ray_points(n, gen)
            args = (packed, pts, dirs, net.xyz_encoder.n_freqs,
                    net.dir_encoder.n_freqs)
            out_k = kernel(*args)
            out_p = plain(*args)
            torch.cuda.synchronize()
            a = agreement(out_k, out_p)
            ms_k = cuda_ms(lambda: kernel(*args), 5)
            ms_p = cuda_ms(lambda: plain(*args), 1)
            tflops = mlp_kernel.flops_per_point(packed) * n / ms_k / 1e9
            checks[(n, branch)] = dict(
                err=a["max_abs_err"], ms=ms_k, plain_ms=ms_p,
                **bound(nbytes(pts, dirs, packed.w, packed.b, out_k),
                        n * mlp_flops(mlp), "bf16"))
            print(f"kernel vs plain, {branch} N={n}: {describe(a)} | kernel "
                  f"{ms_k:.2f} ms ({tflops:.0f} TFLOP/s), plain {ms_p:.2f} ms"
                  f" | {against_first('enc', n, checks[(n, branch)])}")
            if not a["ok"]:
                fail(f"kernel disagrees with its plain version at N={n}")
            if n == POINTS[0] and branch == "coarse":
                for label, round_fn in CONTROLS.items():
                    c = agreement(control_plain(round_fn, *args), out_p)
                    print(f"control, plain with {label}, {branch} N={n}: "
                          f"{describe(c)}")
                    if c["ok"]:
                        fail(f"the check accepts the plain version with "
                             f"{label}, so it cannot see such a fault")
            del out_k, out_p, pts, dirs
    del net
    torch.cuda.empty_cache()

    # -- 3. the slice ----------------------------------------------------
    H = W = 800
    t0 = time.perf_counter()
    views = synthetic_scene.test_views("hard", H, W, [0, 4], device="cuda")
    print(f"ground truth: hard test views 0, 4 at {H}x{W} rendered on the "
          f"card in {time.perf_counter() - t0:.1f} s")
    chunks = math.ceil(H * W / RenderSettings.from_cfg(cfg).ray_chunk)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    res = run_evaluate(cfg, loader=views)
    launches = tracing.counts[kernel_key]
    plain_calls = tracing.counts[plain_key] + tracing.counts["Network.calls"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for rgb in res["rgb"]:
        if rgb.shape != (H * W, 3) or not np.isfinite(rgb).all():
            fail(f"render output is not a finite ({H * W}, 3) image")
    print(f"slice (kernel): PSNR {res['psnr']:.4f} dB, SSIM "
          f"{res['ssim']:.4f} (JAX record {JAX_PSNR_DB} dB), frame times "
          f"{[round(t, 3) for t in res['net_time']]} s, kernel launches "
          f"{launches} (expected {2 * chunks * len(views)}), plain MLP calls "
          f"{plain_calls}, peak memory {peak_gb:.1f} GB")

    cfg_plain = make_cfg(parse_args(argv + ["network.use_pallas_mlp",
                                            "False"]))
    tracing.counts.pop("Network.calls", None)
    res_plain = run_evaluate(cfg_plain, loader=views[:1])
    vs_plain = psnr_uint8(res["rgb"][0], res_plain["rgb"][0])
    frame_k = res["net_time"][0]
    frame_p = res_plain["net_time"][0]
    # per 40000-ray chunk: one coarse launch (2.56M) and one fine (7.68M)
    mlp_ms = chunks * (checks[(POINTS[0], "coarse")]["ms"]
                       + checks[(POINTS[1], "fine")]["ms"])
    print(f"slice (plain MLP, view 0): PSNR vs GT {res_plain['psnr']:.4f} dB,"
          f" kernel render vs plain render {vs_plain:.2f} dB, frame "
          f"{frame_p:.3f} s against {frame_k:.3f} s with the kernel "
          f"(kernel time per frame ~{mlp_ms / 1000:.3f} s), plain MLP calls "
          f"{tracing.counts['Network.calls']} (expected {2 * chunks}), "
          f"kernel launches {tracing.counts[kernel_key] - launches}")

    if launches != 2 * chunks * len(views) or plain_calls != 0:
        fail(f"the slice did not run through the kernel alone (launches "
             f"{launches}, plain calls {plain_calls})")
    if tracing.counts["Network.calls"] != 2 * chunks \
            or tracing.counts[kernel_key] != launches:
        fail(f"the plain render did not run the plain MLP alone (plain "
             f"calls {tracing.counts['Network.calls']}, launches "
             f"{tracing.counts[kernel_key] - launches})")
    if abs(res["psnr"] - JAX_PSNR_DB) > PSNR_BUDGET_DB:
        fail(f"PSNR {res['psnr']:.4f} dB is not within {PSNR_BUDGET_DB} dB "
             f"of {JAX_PSNR_DB} dB")
    if vs_plain < KERNEL_VS_PLAIN_MIN_DB:
        fail(f"kernel render vs plain render {vs_plain:.2f} dB < "
             f"{KERNEL_VS_PLAIN_MIN_DB} dB")

    if opts.profile > 0:
        from nerf_replication_tpu_torch.run import build_renderer

        renderer = build_renderer(cfg, load_model(cfg, torch.device("cuda")))
        profile_runs(lambda: renderer.render(views[0]), FREQ_PROFILE_FRAMES,
                     "frame", "freq_eval")
        del renderer
        torch.cuda.empty_cache()

    # -- 4. the training kernels against plain on a real batch ----------
    t0 = time.perf_counter()
    arrays = synthetic_scene.train_views("hard", H, W, TRAIN_VIEWS,
                                         device="cuda")
    print(f"ground truth: {len(TRAIN_VIEWS)} hard train views at {H}x{W} "
          f"rendered on the card in {time.perf_counter() - t0:.1f} s")
    train_cfg = make_cfg(parse_args(TRAIN_ARGV + [
        "pretrain_path", "data/pretrain/hard"]))
    train_checks = phase_train_kernels(train_cfg, arrays)

    # -- 5. training ------------------------------------------------------
    counts = phase_train(arrays, views, opts.steps, opts.profile)
    torch.cuda.empty_cache()

    # -- 6. NGP eval ------------------------------------------------------
    ngp = phase_ngp(views, opts.profile > 0)

    # -- 7. NGP training --------------------------------------------------
    brick = phase_ngp_train(arrays, views, opts.steps, opts.profile)
    torch.cuda.empty_cache()

    # -- 8. the gather probes ---------------------------------------------
    probes = phase_probes()

    # -- 9. the frame path ------------------------------------------------
    frame = {"freq_rm": phase_frame("freq_rm", argv, views, res, MLP_BOUNDS,
                                    "enc"),
             "ngp": phase_frame("ngp", NGP_ARGV, views, ngp["dense"],
                                NGP_BOUNDS, "ngp")}

    # -- 10. the compacted frequency frame ---------------------------------
    compact = phase_compact(argv, views, res, arrays)
    torch.cuda.empty_cache()

    # -- 11. the xla hash grid and the composite encoders ------------------
    xla = phase_xla(arrays, views, opts.steps, brick["evals"])
    torch.cuda.empty_cache()

    # -- 12. the host loader: img_fit, and the NeRF model ------------------
    host = phase_host_loader(arrays, opts.profile > 0)

    # -- 13. data parallel ----------------------------------------------
    dp = phase_dp(arrays, views, res, {
        "H": H, "W": W, "focal": float(views[0]["focal"]),
        "compact": compact["spec"], "ngp": frame["ngp"]["spec"]})
    del arrays

    def entry(name, source, replaces, launches, readings, frame=None,
              compact=None, more=()):
        """One kernel of the summary: its last reading (its largest size
        on its path); library_ms is the one PyTorch call that computes the
        same function, where there is one (index_add_ for the table
        gradient), else null; for the kernels of the frame path
        (``frame``, phase 9's readings of the kernel), frame_launches is
        its launches in one frame, for #1 on the compacted frame
        (``compact``, phase 10's) compact_frame_launches too, and
        max_abs_err covers their checks and the readings ``more``."""
        big = readings[-1]
        checks = list(more)
        extra = {}
        if frame is not None:
            checks += frame["checks"]
            extra["frame_launches"] = frame["frame_launches"]
        if compact is not None:
            checks += compact["checks"]
            extra["compact_frame_launches"] = compact["frame_launches"]
        return {"name": name, "route": "cuda",
                "source": f"nerf_replication_tpu_torch/csrc/{source}",
                "replaces": f"nerf_replication_tpu/ops/pallas/{replaces}",
                "launches": launches,
                "max_abs_err": max(r["err"] for r in readings + checks),
                "ms": big["ms"], "plain_ms": big["plain_ms"],
                "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
                "library_ms": big.get("library_ms"), **extra}

    def probe_entry(name):
        """One probe: its last reading (the contended one for the atomic
        probe); its plain version is the one PyTorch call it is held
        against, so plain_ms and library_ms are that call's time."""
        mine = [r for r in probes if r["name"] == name]
        big = mine[-1]
        return {"name": name, "route": "cuda",
                "source": "nerf_replication_tpu_torch/csrc/probe_gather.cu",
                "replaces": big["replaces"], "launches": big["launches"],
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": big["ms"], "plain_ms": big["library_ms"],
                "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
                "library_ms": big["library_ms"]}

    train_fine = xla["encode"]["readings"][1]
    eval_fine = xla["encode"]["readings"][-1]
    # phase 12: img_fit runs no kernel; the host-loader NeRF run launches
    # #3/#4 and #5 (host_loader_launches)
    host_counts = host["nerf"]["counts"]
    print(smi)
    summary = {"kernels": [
        entry("fused_nerf_mlp_enc", "fused_nerf_mlp.cu", "mlp_kernel.py:366",
              launches, list(checks.values()), frame["freq_rm"], compact),
        {**entry("fused_nerf_mlp", "fused_nerf_mlp.cu", "mlp_train.py:168",
                 counts["fwd"], train_checks["fwd"],
                 more=compact["train"]["fwd"]),
         "host_loader_launches": host_counts["fwd"]},
        {**entry("fused_nerf_mlp_bwd", "fused_nerf_mlp_bwd.cu",
                 "mlp_train.py:225", counts["bwd"], train_checks["bwd"],
                 more=compact["train"]["bwd"]),
         "host_loader_launches": host_counts["bwd"]},
        entry("brick_encode_eval", "brick_encode_eval.cu",
              "eval_encode.py:202 and :245", ngp["launches"]["encode"],
              ngp["encode"]),
        entry("fused_ngp_eval", "fused_ngp.cu", "fused_ngp.py:258",
              ngp["launches"]["fused"], ngp["fused"], frame["ngp"]),
        entry("fused_ngp_eval_bf16", "fused_ngp.cu",
              "fused_ngp.py:258 (mlp_bf16)", ngp["launches"]["fused_bf16"],
              ngp["fused_bf16"], frame["ngp"]["bf16"]),
        entry("brick_hash_encode", "brick_hash_encode.cu",
              "hashgrid_kernel.py:311", brick["launches"]["fwd"],
              brick["fwd"]),
        entry("brick_hash_encode_bwd", "brick_hash_encode.cu",
              "hashgrid_kernel.py:339", brick["launches"]["bwd"],
              brick["bwd"]),
        *[probe_entry(name) for name in dict.fromkeys(
            r["name"] for r in probes)]],
        # no TPU kernel: the JAX package's xla grid runs in XLA
        "plain_pytorch": [{
            "name": "xla_hash_encode", "route": "pytorch",
            "source": "nerf_replication_tpu_torch/models/encoding/hashgrid.py",
            "replaces": "nerf_replication_tpu/models/encoding/hashgrid.py:133"
                        " (hash_encode, XLA, no pallas_call)",
            "calls": xla["calls"],
            "max_abs_err": max(r["err"] for r in xla["encode"]["readings"]),
            "bwd_max_abs_err": train_fine["bwd_err"],
            "n": train_fine["n"], "ms": train_fine["ms"],
            "bwd_ms": train_fine["bwd_ms"],
            "bound_ms": train_fine["bound_ms"],
            "bound_by": train_fine["bound_by"],
            "bwd_bound_ms": train_fine["bwd_bound_ms"],
            "library_ms": train_fine["library_ms"],
            "eval_n": eval_fine["n"], "eval_ms": eval_fine["ms"],
            "eval_bound_ms": eval_fine["bound_ms"]}]}
    # phase 13: each kernel's launches on each rank of the data-parallel
    # runs
    for k in summary["kernels"]:
        if k["name"] in dp["launches"]:
            k["dp_launches_by_rank"] = dp["launches"][k["name"]]
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
