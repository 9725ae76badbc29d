#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--steps 2000] [--profile 0]

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
   under build/).
6. NGP eval: configs/nerf/hard_ngp.yaml with data/pretrain/hard_ngp_b9
   (``network.xyz_encoder.log2_bricks 9``). (a) The brick-encode and the
   fused encode+MLP kernels against their plain versions on the samples
   of one real 8000-ray chunk of hard view 0 (384,000 coarse and 896,000
   fine points, each through its branch), with three lower-precision
   plain versions that must fail the same check (the table read in f32,
   the MLP in bf16, the MLP in TF32); CUDA-event times beside each
   kernel's bound. (b) ``run_evaluate`` on hard test views 0 and 4 at
   800x800 through the fused route: mean uint8 PSNR against the JAX
   record 30.28 dB, SSIM, frame times, 2 fused launches a chunk and no
   other kernel or plain call. (c) View 0 through the unfused route (the
   encode kernel and the nn.Module MLP, 2 of each a chunk) and the plain
   route (``network.use_pallas_mlp False``: the nn.Module network, whose
   encoder launches the training forward kernel, 2 a chunk): each one's
   PSNR against the fused render and its frame time.
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
   fail that check. CUDA-event times beside the bounds, and the time of
   one ``index_add_`` over the same (address, value) pairs. (b) 2000 steps
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
The last three lines are the card's name and power limit, the kernel
summary (each kernel's launches on its path, error, times and bound) and
the device, the last two as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
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
# version (read: bit-equal); the fused MLP differs from the plain one only
# in its f32 summation order (fmaf chains against cuBLAS), which moves an
# output by <= 6.1e-7 of its column's range (read at 384,000 and 896,000
# points; column medians <= 3.7e-8, no element outside atol + rtol 1e-4).
# The controls (NGP_CONTROLS) read 2.9e-3 (table in f32), 2.0e-2 (MLP in
# bf16) and 3.0e-3 (MLP in TF32) of the range.
NGP_BOUNDS = Bounds(col_rtol=1e-5, atol=1e-4, rtol=1e-4, outlier_frac=1e-5,
                    median_rtol=1e-6)
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
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}


def bound(n_bytes: float, n_ops: float, kind: str) -> dict:
    """``bound_ms`` and ``bound_by`` for moving ``n_bytes`` and doing
    ``n_ops`` operations of type ``kind``."""
    ms_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    ms_ops = n_ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(ms_bytes, ms_ops),
            "bound_by": "bytes" if ms_bytes >= ms_ops else "operations"}


# Times of the first version of the 8x256 MLP kernels (wmma, 64-point
# tiles, weights read from L2 by every block) at the same point counts, on
# an NVIDIA H100 80GB HBM3 at 700 W: printed beside the present kernels'.
FIRST_VERSION_MS = {
    ("enc", 2_560_000): 24.77, ("enc", 7_680_000): 73.23,
    ("fwd", 65_536): 0.657, ("fwd", 196_608): 1.946,
    ("bwd", 65_536): 3.470, ("bwd", 196_608): 9.887}
SMEM_LIMIT = 232_448   # dynamic shared memory a block may use on the card


def against_first(kind: str, n: int, reading: dict) -> str:
    """A reading (ms, bound_ms) beside its bound and the first version's
    time at this size."""
    first = FIRST_VERSION_MS.get((kind, n))
    was = f"first version {first} ms, " if first else ""
    return (f"{was}bound {reading['bound_ms']:.3f} ms by "
            f"{reading['bound_by']} ({reading['bound_ms'] / reading['ms']:.1%}"
            f" of it reached)")


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


def cuda_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    """(object, attribute) of every wrapper's launch count and every plain
    version's and nn.Module's call count."""
    from nerf_replication_tpu_torch.models.nerf.network import NeRFMLP, Network
    from nerf_replication_tpu_torch.ops import (
        eval_encode,
        fused_ngp,
        hashgrid_kernel,
        mlp_kernel,
        mlp_train,
    )

    return {
        "brick_fwd": [(hashgrid_kernel.brick_hash_encode, "launches")],
        "brick_bwd": [(hashgrid_kernel.brick_hash_encode_bwd, "launches")],
        "enc": [(mlp_kernel.fused_nerf_mlp_enc, "launches")],
        "fwd": [(mlp_kernel.fused_nerf_mlp, "launches")],
        "bwd": [(mlp_train.fused_nerf_mlp_bwd, "launches")],
        "ngp_enc": [(eval_encode.brick_encode_eval, "launches")],
        "ngp": [(fused_ngp.fused_ngp_eval, "launches")],
        "plain": [(f, "calls") for f in (
            mlp_kernel.fused_nerf_mlp_enc_reference,
            mlp_kernel.fused_nerf_mlp_reference,
            mlp_train.fused_nerf_mlp_bwd_reference,
            eval_encode.brick_encode_eval_reference,
            fused_ngp.fused_ngp_eval_reference,
            hashgrid_kernel.brick_encode_reference,
            hashgrid_kernel.brick_encode_bwd_reference)],
        "module": [(Network, "calls")],
        "mlp": [(NeRFMLP, "calls")],
    }


def reset_counts():
    """Every wrapper's launch count and every plain version's call count."""
    for counter in _counters().values():
        for obj, attr in counter:
            setattr(obj, attr, 0)


def read_counts() -> dict:
    """Launches of each kernel; calls of the plain versions (summed), of
    ``Network.forward`` (module) and of ``NeRFMLP.forward`` (mlp)."""
    return {name: sum(getattr(obj, attr) for obj, attr in counter)
            for name, counter in _counters().items()}


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
                        packed, x, v), 5)),
            "bwd": (cuda_ms(lambda: mlp_train.fused_nerf_mlp_bwd(
                        packed, x, v, g), 20),
                    cuda_ms(lambda: mlp_train.fused_nerf_mlp_bwd_reference(
                        packed, x, v, g), 5))}
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


def profile_runs(run, count: int, unit: str, tag: str):
    """``count`` calls of ``run`` (after 3 to warm up) under torch.profiler:
    the device time a call by part (PROFILE_PARTS, the rest as "other")
    and the idle share of the wall time; the full table goes to
    build/profile_<tag>.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
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
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", f"profile_{tag}.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=60))
    print(f"profile {tag}: {count} {unit}s under the profiler, wall "
          f"{wall * 1e3 / count:.2f} ms a {unit}, device busy "
          f"{busy * 1e3 / count:.2f} ms a {unit} (idle "
          f"{100 * (1 - busy / wall):.1f}%); device ms a {unit}: " + "; ".join(
              f"{name} {t / 1e3 / count:.3f}" for name, t in
              sorted(parts.items(), key=lambda kv: -kv[1])))


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


# phase 6's controls: label -> (the kernel whose check must reject it, the
# control's output from (encoder, points, that kernel's plain version))
NGP_CONTROLS = {
    "table read in f32 (no bf16 rounding)": ("encode", _table_in_f32),
    "MLP in bf16": ("fused", _mlp_in_bf16),
    "MLP in TF32": ("fused", _mlp_in_tf32),
}


def ngp_kernels_against_plain(cfg, net, view) -> dict:
    """Phase 6 (a): each NGP kernel against its plain version on the
    samples of one real chunk, each branch on its own pass's points; the
    controls on the coarse points. Returns, per kernel, its readings at
    each size."""
    from nerf_replication_tpu_torch.models.nerf.renderer import ngp_renderer
    from nerf_replication_tpu_torch.ops import (
        eval_encode,
        fused_ngp,
        hashgrid_kernel,
    )

    enc = net.xyz_encoder
    layout = enc.layout
    packed = eval_encode.pack_eval_table(enc.table.detach())
    res = {"encode": [], "fused": []}
    for branch, (pts, viewdirs) in ngp_chunk_samples(cfg, net, view).items():
        mlp = getattr(net, branch)
        ops, meta = fused_ngp.extract_mlp_weights(
            mlp.state_dict(), enc.output_dim, mlp.depth, mlp.skips,
            mlp.view_depth)
        x, sh = ngp_renderer.fused_inputs(net, pts, viewdirs)
        n = x.shape[0]
        runs = {"encode": (
            lambda: eval_encode.brick_encode_eval(layout, packed, x),
            lambda: eval_encode.brick_encode_eval_reference(layout, packed, x),
            hashgrid_kernel.encode_flops_per_point(layout)), "fused": (
            lambda: fused_ngp.fused_ngp_eval(layout, meta, packed, ops, x, sh),
            lambda: fused_ngp.fused_ngp_eval_reference(layout, meta, packed,
                                                       ops, x, sh),
            fused_ngp.flops_per_point(layout, ops))}
        for name, (kernel, plain, flops) in runs.items():
            out_k, out_p = kernel(), plain()
            torch.cuda.synchronize()
            a = agreement(out_k, out_p, NGP_BOUNDS)
            ms_k, ms_p = cuda_ms(kernel, 20), cuda_ms(plain, 3)
            inputs = (x, packed) + ((sh, ops.flat) if name == "fused" else ())
            b = bound(nbytes(*inputs, out_k), n * flops, "f32")
            res[name].append(dict(n=n, err=a["max_abs_err"], ms=ms_k,
                                  plain_ms=ms_p, **b))
            print(f"NGP {name} kernel vs plain, {branch} N={n}: "
                  f"{describe(a)}, bit-equal {torch.equal(out_k, out_p)} | "
                  f"kernel {ms_k:.4f} ms (bound {b['bound_ms']:.4f} ms by "
                  f"{b['bound_by']}, {flops * n / ms_k / 1e9:.1f} TFLOP/s), "
                  f"plain {ms_p:.3f} ms")
            if not a["ok"]:
                fail(f"NGP {name} kernel disagrees with its plain version "
                     f"at N={n}")
            controls = NGP_CONTROLS.items() if branch == "coarse" else ()
            for label, (target, control) in controls:
                if target == name:
                    c = agreement(control(enc, x, plain), out_p, NGP_BOUNDS)
                    print(f"control, NGP {name} plain with {label}, "
                          f"{branch} N={n}: {describe(c)}")
                    if c["ok"]:
                        fail(f"the NGP check accepts the plain {name} with "
                             f"{label}, so it cannot see such a fault")
            del out_k, out_p
    return res


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
    if profile:
        renderer = build_renderer(cfg, net)
        profile_runs(lambda: renderer.render(views[0]), NGP_PROFILE_FRAMES,
                     "frame", "ngp_fused")
        del renderer

    # (c) view 0 through the unfused route and the plain route
    unfused = make_renderer(cfg, net).use_apply(
        ngp_renderer.make_ngp_eval_apply(net, fused=False))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rgb = unfused.render(views[0])[0]
    torch.cuda.synchronize()
    routes = {"unfused": (rgb.cpu().numpy(), time.perf_counter() - t0,
                          read_counts(), {"ngp_enc": 2 * chunks,
                                          "mlp": 2 * chunks})}
    del net, unfused
    cfg_plain = make_cfg(parse_args(NGP_ARGV + ["network.use_pallas_mlp",
                                                "False"]))
    reset_counts()
    plain = run_evaluate(cfg_plain, loader=views[:1])
    routes["plain"] = (plain["rgb"][0], plain["net_time"][0], read_counts(),
                       {"module": 2 * chunks, "mlp": 2 * chunks,
                        "brick_fwd": 2 * chunks})
    for route, (image, seconds, counts, nonzero) in routes.items():
        vs_fused = psnr_uint8(image, fused["rgb"][0])
        print(f"NGP {route} route, view 0: PSNR vs the fused render "
              f"{vs_fused:.2f} dB (>= {NGP_ROUTES_MIN_DB}), vs GT "
              f"{psnr_uint8(image, views[0]['colors']):.4f} dB, frame "
              f"{seconds:.4f} s against {fused['net_time'][0]:.4f} s fused, "
              f"counts {counts}")
        if counts != dict.fromkeys(counts, 0) | nonzero:
            fail(f"the NGP {route} route did not run its own path: {counts}")
        if vs_fused < NGP_ROUTES_MIN_DB:
            fail(f"the NGP {route} render is {vs_fused:.2f} dB from the "
                 f"fused render")
    torch.cuda.empty_cache()
    res["launches"] = {"fused": fused_counts["ngp"],
                       "encode": routes["unfused"][2]["ngp_enc"]}
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
    batch: [(x, g) of the coarse pass, (x, g) of the fine pass], g the
    loss's gradient with respect to the encoder's output."""
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.train import make_trainer
    from nerf_replication_tpu_torch.train.cli import make_pipeline

    cfg = _ngp_train_cfg("network.xyz_encoder.log2_bricks", str(log2_bricks),
                         "ep_iter", str(NGP_WARM_STEPS))
    net = make_network(cfg).cuda()
    trainer = make_trainer(cfg, net)
    pipeline = make_pipeline(cfg, arrays, "cuda")
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
        ms = {"fwd": (cuda_ms(lambda: hk.brick_hash_encode(layout, table, x),
                              20),
                      cuda_ms(lambda: hk.brick_encode_reference(layout, table,
                                                                x), 3)),
              "bwd": (cuda_ms(lambda: hk.brick_hash_encode_bwd(layout, x, g),
                              20),
                      cuda_ms(lambda: hk.brick_encode_bwd_reference(
                          layout, x, g), 3))}
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
        print(f"brick training forward vs plain, {tag}: bit-equal {equal}, "
              f"max_abs_err {fwd_err:.3e}; plain with the table read in f32 "
              f"differs by {float((out_c - out_p).abs().max()):.3e} | kernel "
              f"{ms['fwd'][0]:.4f} ms (bound {bounds['fwd']['bound_ms']:.4f} "
              f"ms by {bounds['fwd']['bound_by']}), plain {ms['fwd'][1]:.3f} "
              f"ms; {touched} table entries touched")
        print(f"brick table gradient vs plain summed in f64, {tag} (g "
              f"contiguous {g.is_contiguous()}): {describe_brick_bwd(a)} | "
              f"kernel {ms['bwd'][0]:.4f} ms (bound "
              f"{bounds['bwd']['bound_ms']:.4f} ms by "
              f"{bounds['bwd']['bound_by']}), plain {ms['bwd'][1]:.3f} ms; "
              f"one index_add_ over the same {16 * len(rows) * n} pairs "
              f"{scatter_ms:.3f} ms")
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
                  stops=(1, 2, 3, 4)) -> dict:
    """One arm of phase 7 through the train CLI's ``train()``: epochs of
    ``steps // 4`` steps from the fresh seed-0 init up to the first of
    ``stops``, then a run resumed from the checkpoint up to each later
    stop, with an eval at every stop. ``plain`` forces the encoder's
    autograd.Function to its plain forward and backward on the card."""
    from nerf_replication_tpu_torch.evaluators import psnr_uint8
    from nerf_replication_tpu_torch.ops import hashgrid_kernel as hk
    from nerf_replication_tpu_torch.run import build_renderer
    from nerf_replication_tpu_torch.train.cli import train

    label = "plain" if plain else "kernels"
    opts = ["ep_iter", str(steps // 4), "trained_model_dir",
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
    arm = dict(cfg=cfg, trainer=trainer, counts=counts, steps=trainer.step,
               losses=losses, images=images, evals=evals, peak_gb=peak_gb,
               eval_psnr=evals[trainer.step],
               rays_per_s=[s["rays_per_s"] for s in summaries])
    print(f"NGP train ({label}): {arm['steps']} steps in epochs "
          f"{[s['epoch'] for s in summaries]} (each after the first resumed "
          f"from the checkpoint), rays/s per epoch "
          f"{[round(r) for r in arm['rays_per_s']]}, final smoothed loss "
          f"{float(np.median(losses[-20:])):.5f}, train PSNR "
          f"{float(np.median(psnrs[-20:])):.2f} dB, peak memory in training "
          f"{peak_gb:.2f} GB, eval PSNR (hard test views 0, 4, 800x800, fused "
          f"NGP eval) by step "
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
    return res


def phase_probes() -> list[dict]:
    """Phase 8: scripts/probe_cuda_gather.py's probes; returns its
    readings, each with the launches its run made."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "probe_cuda_gather", os.path.join(ROOT, "scripts",
                                          "probe_cuda_gather.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    for wrapper in probe.PROBES:
        wrapper.launches = 0
    readings = probe.run()
    torch.cuda.synchronize()
    launches = {f"probe_{w.__name__}": w.launches for w in probe.PROBES}
    for r in readings:
        r["launches"] = launches[r["name"]]
        if not r["ok"] or not r["launches"]:
            fail(f"{r['name']} disagrees with PyTorch indexing or did not "
                 f"launch")
    return readings


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=TRAIN_STEPS,
                        help="training steps per arm (a multiple of 4)")
    parser.add_argument("--profile", type=int, default=0,
                        help="profile this many more steps of each arm "
                             "and of the NGP kernel arm (and 5 fused NGP "
                             "frames)")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    from nerf_replication_tpu_torch.config import make_cfg, parse_args
    from nerf_replication_tpu_torch.evaluators import psnr_uint8
    from nerf_replication_tpu_torch.models.nerf.network import Network
    from nerf_replication_tpu_torch.models.nerf.renderer import RenderSettings
    from nerf_replication_tpu_torch.ops import (
        _build,
        fused_ngp,
        mlp_kernel,
        mlp_train,
    )
    from nerf_replication_tpu_torch.run import load_model, run_evaluate
    from nerf_replication_tpu_torch.utils import synthetic_scene

    os.chdir(ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernel = mlp_kernel.fused_nerf_mlp_enc
    plain = mlp_kernel.fused_nerf_mlp_enc_reference

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
    _build.build_all(libs)   # one nvcc each, all started together
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
            ms_p = cuda_ms(lambda: plain(*args), 2)
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
    launches, plain_calls = kernel.launches, plain.calls + Network.calls
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
    Network.calls = 0
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
          f"{Network.calls} (expected {2 * chunks}), kernel launches "
          f"{kernel.launches - launches}")

    if launches != 2 * chunks * len(views) or plain_calls != 0:
        fail(f"the slice did not run through the kernel alone (launches "
             f"{launches}, plain calls {plain_calls})")
    if Network.calls != 2 * chunks or kernel.launches != launches:
        fail(f"the plain render did not run the plain MLP alone (plain "
             f"calls {Network.calls}, launches {kernel.launches - launches})")
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
    del arrays
    torch.cuda.empty_cache()

    # -- 8. the gather probes ---------------------------------------------
    probes = phase_probes()

    def entry(name, source, replaces, launches, readings):
        """One kernel of the summary: its last reading (its largest size
        on its path); no single PyTorch call computes any of these
        functions, so library_ms is null."""
        big = readings[-1]
        return {"name": name, "route": "cuda",
                "source": f"nerf_replication_tpu_torch/csrc/{source}",
                "replaces": f"nerf_replication_tpu/ops/pallas/{replaces}",
                "launches": launches,
                "max_abs_err": max(r["err"] for r in readings),
                "ms": big["ms"], "plain_ms": big["plain_ms"],
                "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
                "library_ms": None}

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

    print(smi)
    print(json.dumps({"kernels": [
        entry("fused_nerf_mlp_enc", "fused_nerf_mlp.cu", "mlp_kernel.py:366",
              launches, list(checks.values())),
        entry("fused_nerf_mlp", "fused_nerf_mlp.cu", "mlp_train.py:168",
              counts["fwd"], train_checks["fwd"]),
        entry("fused_nerf_mlp_bwd", "fused_nerf_mlp_bwd.cu",
              "mlp_train.py:225", counts["bwd"], train_checks["bwd"]),
        entry("brick_encode_eval", "brick_encode_eval.cu",
              "eval_encode.py:202 and :245", ngp["launches"]["encode"],
              ngp["encode"]),
        entry("fused_ngp_eval", "fused_ngp.cu", "fused_ngp.py:258",
              ngp["launches"]["fused"], ngp["fused"]),
        entry("brick_hash_encode", "brick_hash_encode.cu",
              "hashgrid_kernel.py:311", brick["launches"]["fwd"],
              brick["fwd"]),
        entry("brick_hash_encode_bwd", "brick_hash_encode.cu",
              "hashgrid_kernel.py:339", brick["launches"]["bwd"],
              brick["bwd"]),
        *[probe_entry(name) for name in dict.fromkeys(
            r["name"] for r in probes)]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
