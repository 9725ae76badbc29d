"""Frame bench of the port: frames through the occupancy-raymarch frame
path, behind a quality gate. The counterpart of bench.py's
``_raymarch_bench`` (bench.py:465) with ``run_freq_raymarch`` (:417) and
``run_ngp`` (:314), and of its compacted frequency frame ``run_freq``
(:784):

    python -m nerf_replication_tpu_torch.raymarch_bench --model freq_rm
    python -m nerf_replication_tpu_torch.raymarch_bench --model ngp
    python -m nerf_replication_tpu_torch.raymarch_bench --model freq

``freq_rm`` and ``ngp``:

1. occupancy grids of the network's own density (64^3 dilated 2 cells for
   the span probe, 128^3 dilated 1 cell for the candidate selection);
2. the dense reference of the gate views through ``render_rays_batch``;
3. the gate: the mean uint8 test PSNR of the frame path over the GT test
   views (hard test views 0 and 4 of the procedural scene, rendered on
   the device) may lie at most 0.2 dB below the dense render's. A scene
   without procedural ground truth falls back to the frame against the
   dense frame (>= 40 dB), marked so in the output;
4. the ladder of (candidates, coarse, fine) sample counts, walked until a
   step passes, each step with its capacities fitted to the frame's
   measured ray counts (autocap); if none passes with the accelerated
   probe (``probe_sub`` auto, ``probe_stride`` 2) the ladder is walked
   again with the conservative probe (4, 1);
5. for NGP networks, the fused kernel's bf16 arm at the passing step,
   adopted only if the gate still passes;
6. a window of timed frames on an orbit (100 by default: seconds, not a
   handful of frames), each frame dispatched before the last is read
   back; one JSON line in bench.py's shape (``render_fps_800x800`` with
   its ``gate`` dict; ``render_fps_<size>x<size>`` at another ``--size``).

``freq`` (:func:`compact_frame`): the compacted frame of
``Renderer.make_frame_renderer`` through the encode+MLP kernel, with one
64^3 grid (threshold 0.05, dilated 2 cells); budgets 0.35 fine / 0.4
coarse, refitted to the first frame's active rays (:func:`freq_autocap`);
the 2-segment ERT fine pass adopted only if its frame of the first pose
lies >= 45 dB from the 1-segment frame's (the ``gate``, kind ``freq-ert``
or ``freq-dense``). Beside it the other families' gate (:class:`Gate`:
on the GT views a drop of at most 0.2 dB against the dense render) as a
check, reported as ``gt_drop``; a failed check is a warning line, as an
overflow is.

bench.py's defaults are constants here; ``--size``, ``--frames`` and
``--ray_chunk`` (a reading at another chunk than the config's says so in
its JSON) remain, and config overrides follow the options (``device cpu``
renders on the CPU, and the JSON's ``platform`` says so). Not ported, because they are machinery of the TPU runs
(ROADMAP.md, "Do not port"): the watchdog, the stale-metric replay and
the on-disk grid, dense and ladder caches. Each run builds and walks
anew. TF32 is turned off as in ``run.py``; ray directions and sample
positions do not use matmuls anyway.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from .config import make_cfg, parse_args
from .evaluators import psnr_uint8
from .models.nerf.renderer import Renderer, RenderSettings, ngp_renderer
from .run import build_grids, build_renderer, load_model, resolve_device
from .utils import synthetic_scene

# bench.py:634-636
DEFAULT_LADDER = ("16,8,6;24,10,8;32,10,10;32,12,10;32,12,12;32,14,12;"
                  "40,16,14;48,20,16;64,32,24")
MODELS = {
    "freq": ["--cfg_file", "configs/nerf/hard.yaml", "pretrain_path",
             "data/pretrain/hard"],
    "freq_rm": ["--cfg_file", "configs/nerf/hard.yaml", "pretrain_path",
                "data/pretrain/hard"],
    "ngp": ["--cfg_file", "configs/nerf/hard_ngp.yaml", "pretrain_path",
            "data/pretrain/hard_ngp_b9", "network.xyz_encoder.log2_bricks",
            "9"],
}
GT_VIEWS = 2            # bench.py's BENCH_NGP_GT_VIEWS
BASELINE_FPS = 5.0      # bench.py's vs_baseline divisor
# bench.py's defaults: the grids (BENCH_OCC_RES, BENCH_SEL_RES,
# BENCH_OCC_THRESH), the first budget (BENCH_CAPACITY), the accelerated
# probe (BENCH_PROBE_SUB, BENCH_PROBE_STRIDE) and the gate
# (BENCH_NGP_GATE_DROP, and BENCH_NGP_GATE without ground truth)
OCC_RES, SEL_RES, OCC_THRESH = 64, 128, 0.02
CAPACITY = 0.35
PROBE = ("auto", 2)
GATE_DROP_DB, GATE_DB = 0.2, 40.0
CAMERA_ANGLE_X = synthetic_scene.CAMERA_ANGLE_X
# run_freq's defaults (BENCH_OCC_RES, BENCH_OCC_THRESH, BENCH_CAPACITY,
# BENCH_COARSE_CAPACITY, BENCH_ERT_GATE)
FREQ_OCC_RES, FREQ_OCC_THRESH = 64, 0.05
FREQ_CAPACITY, FREQ_COARSE_CAPACITY = 0.35, 0.4
ERT_GATE_DB = 45.0


def parse_ladder(text: str) -> list[tuple[int, int, int]]:
    """"C,M,F;C,M,F;..." -> [(C, M, F), ...]."""
    return [tuple(int(v) for v in step.split(","))
            for step in text.split(";") if step]


@dataclasses.dataclass
class Caps:
    """The frame renderer's ray budgets, fractions of H*W: ``capacity``
    (active rays), ``occ`` (rays with an occupied candidate) and ``fine``
    (None: 0.85 x capacity)."""
    capacity: float = 0.35
    occ: float = 0.35
    fine: float | None = None


def autocap(stats: dict, n_pixels: int, caps: Caps) -> Caps | None:
    """Budgets fitted to a frame's measured ray counts (bench.py:684-705):
    active rays x 1.1 + 0.02 bound the selection, rays with an occupied
    candidate x 1.15 + 0.01 the coarse field eval, rays with non-trivial
    coarse opacity x 1.15 + 0.01 the fine pass. None when every budget is
    within 0.015 of the present one (and the fine one is set)."""
    active = stats["active_rays"] / n_pixels
    cap = min(1.0, active * 1.1 + 0.02)
    occ = min(cap, stats["occ_rays"] / n_pixels * 1.15 + 0.01)
    fine = min(occ, stats["nontrivial_rays"] / n_pixels * 1.15 + 0.01)
    if (abs(cap - caps.capacity) > 0.015 or caps.fine is None
            or abs(occ - caps.occ) > 0.015 or abs(fine - caps.fine) > 0.015):
        return Caps(cap, occ, fine)
    return None


def host_stats(stats: dict) -> dict:
    return {k: float(v) for k, v in stats.items()}


def walk_ladder(build, gate, ladder, caps: Caps, probe, n_pixels: int,
                first_pose, log=print):
    """Walk ``ladder`` until ``gate`` passes (bench.py:670-734).

    ``build(C, M, F, caps, probe_sub, probe_stride)`` makes a frame
    renderer returning ``(img, stats)``; ``gate(fn, label, first_img)``
    returns ``(passed, info)``. The first step renders ``first_pose``,
    refits the budgets (``autocap``) and renders again if they moved;
    that image is the gate's first view. If no step passes with the
    accelerated ``probe`` (sub, stride) the ladder is walked again with
    (4, 1) and the budgets as they stand. Returns a dict with the passing
    ``step``, its frame ``fn``, ``caps``, ``probe``, ``stats`` and the
    gate's ``info``, or None."""
    for C, M, F in ladder:
        fn = build(C, M, F, caps, *probe)
        img, stats = fn(first_pose)
        stats = host_stats(stats)
        fitted = autocap(stats, n_pixels, caps)
        if fitted is not None:
            log(f"autocap: active {stats['active_rays'] / n_pixels:.3f} -> "
                f"cap {fitted.capacity:.2f}, occ {fitted.occ:.2f}, fine "
                f"{fitted.fine:.2f}")
            caps = fitted
            fn = build(C, M, F, caps, *probe)
            img, stats = fn(first_pose)
            stats = host_stats(stats)
        log(f"ladder C={C} M={M} F={F}: stats={stats}")
        passed, info = gate(fn, f"ladder C={C} M={M} F={F}", img)
        if passed:
            return {"step": (C, M, F), "fn": fn, "caps": caps,
                    "probe": probe, "stats": stats, "info": info}
    if tuple(probe) != (4, 1):
        log("gate: no ladder step passed with the accelerated probe; "
            "retrying with probe_sub=4 stride=1")
        for C, M, F in ladder:
            fn = build(C, M, F, caps, 4, 1)
            passed, info = gate(fn, f"ladder(conservative) C={C} M={M} "
                                f"F={F}", None)
            if passed:
                img, stats = fn(first_pose)
                return {"step": (C, M, F), "fn": fn, "caps": caps,
                        "probe": (4, 1), "stats": host_stats(stats),
                        "info": info}
    return None


class Gate:
    """The quality gate over ``views`` (test batches with a ``pose``):
    with ``gt`` the mean uint8 PSNR of the frame path against the views'
    ground truth may lie at most ``drop_db`` below ``dense_psnr``; without,
    the first frame against the dense frame must reach ``min_db``.
    ``dense`` holds the dense images (N, 3) in [0, 1]."""

    def __init__(self, views, dense, gt: bool, dense_psnr=None,
                 drop_db: float = 0.2, min_db: float = 40.0, log=print):
        self.views, self.dense, self.gt = views, dense, gt
        self.dense_psnr, self.drop_db, self.min_db = dense_psnr, drop_db, \
            min_db
        self.log = log

    def __call__(self, fn, label: str, first_img=None):
        imgs = [first_img if i == 0 and first_img is not None
                else fn(view["pose"])[0] for i, view in enumerate(self.views)]
        imgs = [im.cpu().numpy().astype(np.float32) / 255.0 for im in imgs]
        q = psnr_uint8(imgs[0], self.dense[0])
        if self.gt:
            fast = float(np.mean([psnr_uint8(im, v["colors"])
                                  for im, v in zip(imgs, self.views)]))
            drop = self.dense_psnr - fast
            self.log(f"{label}: test {fast:.4f} dB (drop {drop:+.4f} vs "
                     f"dense, budget {self.drop_db}; {q:.2f} dB vs dense "
                     "frame)")
            return drop <= self.drop_db, {"psnr": fast, "drop": drop,
                                          "q_vs_dense_db": q}
        self.log(f"{label}: {q:.2f} dB vs dense (gate {self.min_db})")
        return q >= self.min_db, {"q_vs_dense_db": q}


def gated_frame(net, apply_fn, frame_args, gate, ladder, first_pose,
                log=print):
    """The gated frame: :func:`walk_ladder` from the first budget and the
    accelerated probe, then, for a brick-NGP ``net``, the fused kernel's
    bf16 arm at the passing step, adopted only if ``gate`` still passes.
    ``frame_args`` are :func:`frame_factory`'s after the apply, (H, W,
    focal, occupancy, select, settings). Returns ``(chosen, bf16)``:
    walk_ladder's result (None when no step passes) and None, or for a
    brick-NGP net the bf16 arm's ``{"fn", "apply", "passed", **info}``."""
    H, W = frame_args[:2]
    chosen = walk_ladder(frame_factory(apply_fn, *frame_args), gate, ladder,
                         Caps(CAPACITY, CAPACITY, None), PROBE, H * W,
                         first_pose, log=log)
    if chosen is None or not ngp_renderer.is_brick_ngp(net):
        return chosen, None
    apply16 = ngp_renderer.make_ngp_eval_apply(net, mlp_bf16=True)
    fn16 = frame_factory(apply16, *frame_args)(*chosen["step"],
                                               chosen["caps"],
                                               *chosen["probe"])
    passed, info = gate(fn16, "bf16-MLP refinement")
    log("bf16-MLP refinement PASSED; adopting" if passed
        else "bf16-MLP refinement failed the gate; keeping f32")
    return chosen, {"fn": fn16, "apply": apply16, "passed": passed, **info}


def frame_factory(apply_fn, H: int, W: int, focal: float, occupancy,
                  select, settings):
    """``build(C, M, F, caps, probe_sub, probe_stride)`` for
    :func:`walk_ladder`: uint8 frames with stats."""
    def build(C, M, F, caps, probe_sub, probe_stride, **kw):
        return ngp_renderer.make_ngp_frame_renderer(
            apply_fn, H, W, focal, occupancy, settings, n_candidates=C,
            n_coarse=M, n_fine=F, capacity=caps.capacity,
            fine_capacity=caps.fine, occ_capacity=caps.occ,
            select_occupancy=select, probe_sub=probe_sub,
            probe_stride=probe_stride, out_dtype=torch.uint8,
            return_stats=True, **kw)
    return build


def freq_autocap(active_rays: float, n_pixels: int, capacity: float,
                 coarse_capacity: float) -> tuple[float, float] | None:
    """run_freq's budgets fitted to a frame's active rays (bench.py:868-
    880): coarse ``min(1, a x 1.15 + 0.02)``, fine ``min(coarse, a x 1.10 +
    0.02)`` of the active share ``a``; None unless either moves by more
    than 0.03."""
    active = active_rays / n_pixels
    new_ccap = min(1.0, active * 1.15 + 0.02)
    new_cap = min(new_ccap, active * 1.10 + 0.02)
    if abs(new_ccap - coarse_capacity) > 0.03 or abs(new_cap - capacity) \
            > 0.03:
        return new_cap, new_ccap
    return None


def compact_frame(renderer, H: int, W: int, focal: float, occupancy,
                  first_pose, log=print) -> dict:
    """The ``freq`` family's frame (bench.py:784-917): uint8 frames of
    ``Renderer.make_frame_renderer`` with ``occupancy``, at the default
    budgets, refitted once to ``first_pose``'s active rays
    (:func:`freq_autocap`); a warning on any overflow; then the ERT gate,
    the 2-segment frame of ``first_pose`` against the 1-segment one, the
    former adopted at >= ERT_GATE_DB. Returns the adopted ``fn``, both
    frames (``dense_fn`` 1 segment, ``ert_fn`` 2), ``caps`` (fine,
    coarse), the 1-segment ``stats`` and the ERT frame's ``ert_stats`` of
    ``first_pose``, and the ``gate`` dict."""
    def build(capacity, coarse_capacity, segments):
        r = Renderer(renderer.net, settings=dataclasses.replace(
            renderer.settings, ert_segments=segments)).use_apply(
                renderer.apply_fn)
        return r.make_frame_renderer(
            H, W, focal, capacity=capacity, coarse_capacity=coarse_capacity,
            out_dtype=torch.uint8, occupancy=occupancy, return_stats=True)

    caps = (FREQ_CAPACITY, FREQ_COARSE_CAPACITY)
    fn = build(*caps, 1)
    img, stats = fn(first_pose)
    stats = host_stats(stats)
    log(f"frame stats: {stats}")
    fitted = freq_autocap(stats["active_rays"], H * W, *caps)
    if fitted is not None:
        log(f"autocap: active {stats['active_rays'] / (H * W):.3f} -> "
            f"coarse {fitted[1]:.2f}, fine {fitted[0]:.2f}")
        caps = fitted
        fn = build(*caps, 1)
        img, stats = fn(first_pose)
        stats = host_stats(stats)
        log(f"frame stats: {stats}")
    if stats["coarse_overflow"] or stats["fine_overflow"]:
        log("WARNING: capacity overflow - some real rays rendered "
            "coarse-only or as background")
    ert_fn = build(*caps, 2)
    ert_img, ert_stats = ert_fn(first_pose)
    q = psnr_uint8(ert_img.cpu().numpy().astype(np.float32) / 255.0,
                   img.cpu().numpy().astype(np.float32) / 255.0)
    if q >= ERT_GATE_DB:
        log(f"ERT gate PASSED ({q:.1f} dB >= {ERT_GATE_DB}): 2-segment ERT "
            "on")
        gate = {"kind": "freq-ert", "q_vs_dense_db": round(q, 1),
                "gate_db": ERT_GATE_DB}
    else:
        log(f"ERT gate failed ({q:.1f} dB < {ERT_GATE_DB}): dense path kept")
        gate = {"kind": "freq-dense", "q_vs_dense_db": round(q, 1)}
    return {"fn": ert_fn if q >= ERT_GATE_DB else fn, "dense_fn": fn,
            "ert_fn": ert_fn, "caps": caps, "stats": stats,
            "ert_stats": host_stats(ert_stats), "gate": gate,
            "q_vs_dense_db": q}


def orbit_poses(frames: int) -> list[np.ndarray]:
    """bench.py's orbit: ``frames`` poses at radius 4, height 1.5."""
    return [synthetic_scene.look_at_pose(np.array(
        [4.0 * np.cos(a), 4.0 * np.sin(a), 1.5], dtype=np.float32))
        for a in np.linspace(0, 2 * np.pi, frames + 1)[:-1]]


def time_frames(fn, poses) -> float:
    """Seconds a frame, with one frame of overlap: frame i+1 is
    dispatched before frame i is read back (bench.py:266)."""
    pending = []
    t0 = time.perf_counter()
    for pose in poses:
        pending.append(fn(pose))
        if len(pending) > 1:
            pending.pop(0)[0].cpu()
    while pending:
        pending.pop(0)[0].cpu()
    return (time.perf_counter() - t0) / len(poses)


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", choices=sorted(MODELS), default="freq_rm")
    p.add_argument("--size", type=int, default=800)
    p.add_argument("--frames", type=int, default=100,
                   help="frames in the timed window")
    p.add_argument("--ray_chunk", type=int, default=None,
                   help="rays a chunk (default: the config's)")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="config overrides")
    a = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def log(msg):
        print(msg, flush=True)

    cfg = make_cfg(parse_args(["--type", "evaluate", *MODELS[a.model],
                               "device", "cuda", "save_result", "False",
                               *a.opts]))
    device = resolve_device(cfg)
    net = load_model(cfg, device)
    renderer = build_renderer(cfg, net)
    if a.ray_chunk is not None:
        renderer.settings = dataclasses.replace(renderer.settings,
                                                ray_chunk=a.ray_chunk)
    settings: RenderSettings = renderer.settings
    apply_fn = renderer.apply_fn
    H = W = a.size
    log(f"raymarch bench: {a.model}, {H}x{W}, ray_chunk "
        f"{settings.ray_chunk}, device {device}")

    t0 = time.perf_counter()
    occupancy, select = (
        build_grids(apply_fn, settings, device, FREQ_OCC_RES, 0,
                    FREQ_OCC_THRESH) if a.model == "freq" else
        build_grids(apply_fn, settings, device, OCC_RES, SEL_RES, OCC_THRESH))
    if device.type == "cuda":
        torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    log(f"occupancy grids: {occupancy[0].float().mean().item():.3f} / "
        f"{select[0].float().mean().item() if select else float('nan'):.3f}"
        f" occupied, built in {grid_s:.2f} s")

    focal = W / (2.0 * np.tan(CAMERA_ANGLE_X / 2.0))
    gt = cfg.get("scene", "") in synthetic_scene.SCENES
    if gt:
        stride = max(1, synthetic_scene.N_TEST // GT_VIEWS)
        idx = list(range(0, synthetic_scene.N_TEST, stride))[:GT_VIEWS]
        views = synthetic_scene.test_views(cfg.scene, H, W, idx,
                                           device=device)
        log(f"gate: GT test views {idx} (drop budget {GATE_DROP_DB} dB)")
    else:
        log("WARNING: no procedural ground truth for this scene - the gate "
            f"degrades to the frame-vs-dense >= {GATE_DB} dB criterion; "
            "numbers gated this way are marked gate=frame-vs-dense")
        pose = orbit_poses(1)[0]
        ro, rd = synthetic_scene.camera_rays(pose, H, W, focal)
        views = [{"pose": pose, "rays_o": ro.reshape(-1, 3),
                  "rays_d": rd.reshape(-1, 3)}]

    t0 = time.perf_counter()
    dense = [renderer.render_rays_batch(v["rays_o"], v["rays_d"])["rgb"]
             .clamp(0, 1).cpu().numpy() for v in views]
    dense_s = (time.perf_counter() - t0) / len(views)
    dense_psnr = (float(np.mean([psnr_uint8(d, v["colors"])
                                 for d, v in zip(dense, views)]))
                  if gt else None)
    log(f"dense reference: {dense_s:.3f} s a frame"
        + (f", test PSNR {dense_psnr:.4f} dB" if gt else ""))
    out = {"metric": f"render_fps_{H}x{W}", "unit": "fps",
           "platform": "gpu" if device.type == "cuda" else device.type,
           "device": card() if device.type == "cuda" else "cpu",
           "size": H, "ray_chunk": settings.ray_chunk}
    poses = [torch.as_tensor(p, device=device)
             for p in orbit_poses(a.frames)]
    gate = Gate(views, dense, gt, dense_psnr, GATE_DROP_DB, GATE_DB, log)
    if a.model == "freq":
        frame = compact_frame(renderer, H, W, focal, occupancy, poses[0],
                              log=log)
        passed, info = gate(frame["fn"], "GT-drop check")
        if not passed:
            log("WARNING: the compacted frame fails the GT-drop check")
        summary = {**frame["gate"], "family": a.model,
                   "caps": list(frame["caps"]), "stats": frame["stats"],
                   "gt_drop": {"passed": passed, **info}}
        time_frames(frame["fn"], poses[:1])          # warm-up
        per = time_frames(frame["fn"], poses)
        log(f"frames: {len(poses)} at {per:.4f} s a frame")
        out.update(value=round(1.0 / per, 3),
                   vs_baseline=round(1.0 / per / BASELINE_FPS, 3),
                   gate=summary)
        print(json.dumps(out))
        return out

    chosen, bf16 = gated_frame(net, apply_fn,
                               (H, W, focal, occupancy, select, settings),
                               gate, parse_ladder(DEFAULT_LADDER),
                               views[0]["pose"], log=log)
    if chosen is None:
        log("gate: no ladder step passed; reporting the dense path's fps")
        fps = 1.0 / dense_s
        out.update(value=round(fps, 3),
                   vs_baseline=round(fps / BASELINE_FPS, 3),
                   gate={"kind": "dense-fallback", "family": a.model})
        print(json.dumps(out))
        return out
    C, M, F = chosen["step"]
    log(f"gate PASSED at C,M,F={chosen['step']} "
        f"({chosen['info']['q_vs_dense_db']:.2f} dB vs dense frame)")
    fn = bf16["fn"] if bf16 and bf16["passed"] else chosen["fn"]
    time_frames(fn, poses[:1])          # warm-up
    per = time_frames(fn, poses)
    fps = 1.0 / per
    arm = ("" if bf16 is None
           else f" ({'bf16' if bf16['passed'] else 'f32'} arm)")
    log(f"frames: {len(poses)} at {per:.4f} s a frame{arm}")
    caps = chosen["caps"]
    out.update(value=round(fps, 3), vs_baseline=round(fps / BASELINE_FPS, 3),
               gate={"kind": "gt-drop" if gt else "frame-vs-dense",
                     "family": a.model, "ladder": [C, M, F],
                     "q_vs_dense_db": round(chosen["info"]["q_vs_dense_db"],
                                            2),
                     "caps": [caps.capacity, caps.occ, caps.fine],
                     "probe": list(chosen["probe"]),
                     "stats": chosen["stats"],
                     **({"drop_budget_db": GATE_DROP_DB,
                         "dense_test_psnr": round(dense_psnr, 4),
                         "fast_test_psnr": round(chosen["info"]["psnr"], 4)}
                        if gt else {"gate_db": GATE_DB}),
                     **({"bf16": {k: v for k, v in bf16.items()
                                  if k not in ("fn", "apply")}}
                        if bf16 else {})})
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
