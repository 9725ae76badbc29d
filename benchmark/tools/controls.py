"""Readings of a cell's control and faults, at the cell's own size, for
setting its limits (PERF.md gives them beside the limits).

    python benchmark/tools/controls.py --workload freq-train --seeds 11 12 13

The control is the plain reference in the program's place, computed in
the precision below the configuration's (``precision.control``: fp8
for bfloat16 products, TF32 for float32 ones), compared with the
float32 reference as a run compares the program. Training cells also
read two faults planted in that stand-in: the mean loss over half of
the batch, and a step that leaves the state unchanged. Frame cells read
a frame altered where it is produced (a block of its pixels black).
One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness import inputs, specs, yardstick  # noqa: E402
from benchmark.reference import field as ref_field  # noqa: E402
from benchmark.reference import frame_path as ref_frame  # noqa: E402
from benchmark.reference import render as ref_render  # noqa: E402


LOSS_OF = ref_render.loss_of


def half_batch_loss(field, w, batch, r, gen):
    """The fault: the loss's mean taken over the first half of the rays."""
    rays_o, rays_d, colors, bg = batch
    h = rays_o.shape[0] // 2
    return LOSS_OF(field, w, (rays_o[:h], rays_d[:h], colors[:h],
                              None if bg is None else bg[:h]), r, gen)


def train_readings(w, c, seed, device, data):
    """The control's and the faults' training readings. Each stand-in
    trains the start from the seed's weights; its late epoch starts, as
    the reference's does, from the float32 reference's state after the
    start, taken as the state at the late epoch's first step."""
    from benchmark.traffic.train import compare, late_epoch

    n = w["params"]["steps_per_call"]
    shapes = yardstick.weight_shapes(c["model"])
    w0 = inputs.init_weights(shapes, c["model"], seed, device)
    epoch, step = late_epoch(c["train"]["precrop_iters"], n)

    def run(prec="float32", loss=None, begin=None):
        saved = ref_render.loss_of
        if loss is not None:
            ref_render.loss_of = loss
        field = ref_field.Field(c["model"], ref_field.Precision(prec))
        try:
            start = ref_render.train_steps(field, w0, data, c["render"],
                                           c["train"], seed, [(0, 1), (1, n)])
            begin = begin or {**start["state"], "weights": start["weights"],
                              "t": step}
            late = ref_render.train_steps(field, begin["weights"], data,
                                          c["render"], c["train"], seed,
                                          [(epoch, n)], begin)
        finally:
            ref_render.loss_of = saved
        return {"start": start, "late": late}, begin

    ref, begin = run()
    w_late = begin["weights"]
    out = {"control": compare(ref, run(c["precision"]["control"],
                                       begin=begin)[0], w0, w_late),
           "half_batch": compare(ref, run(loss=half_batch_loss,
                                          begin=begin)[0], w0, w_late)}
    unchanged = {"start": {**ref["start"], "weights": w0},
                 "late": {**ref["late"], "weights": w_late}}
    out["unchanged"] = compare(ref, unchanged, w0, w_late)
    return out


def frame_readings(w, c, seed, device):
    from benchmark.traffic.dense_frame import rms_levels

    p = w["params"]
    H, W = p["H"], p["W"]
    focal = inputs.focal_of(W)
    weights = {k: v.to(device) for k, v in ref_field.load_checkpoint(
        f"{c['port']['checkpoint']}/pretrain.ckpt").items()}
    poses = torch.as_tensor(inputs.orbit_poses(p["poses"]), device=device)
    pose = poses[int(torch.randint(p["poses"], (), generator=torch.Generator()
                                   .manual_seed(seed)))]

    def render(prec):
        field = ref_field.Field(c["model"], ref_field.Precision(prec))
        if w["traffic"] == "view_frame":
            return ref_frame.FramePath(field, weights, H, W, focal,
                                       c["render"], p, device)(pose)
        return ref_render.dense_frame(field, weights, pose, H, W, focal,
                                      c["render"])

    ref = render("float32")
    altered = ref.clone().reshape(H, W, 3)
    altered[H // 2 - 8:H // 2 + 8, W // 2 - 8:W // 2 + 8] = 0
    return {"control": {"rms_levels": rms_levels(
                render(c["precision"]["control"]), ref)},
            "altered": {"rms_levels": rms_levels(altered.reshape(-1, 3),
                                                 ref)}}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    os.chdir(ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    w = specs.workload(args.workload)
    c = specs.config(w["config"])
    data = None
    if w["traffic"] == "train":
        p = w["params"]
        images, alphas, poses, K = inputs.train_views(p["views"], p["H"],
                                                      p["W"], device)
        data = {"images": images, "alphas": alphas,
                "poses": torch.as_tensor(poses, device=device),
                "K": torch.as_tensor(K)}
    for seed in args.seeds:
        got = (train_readings(w, c, seed, device, data) if data is not None
               else frame_readings(w, c, seed, device))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "limits": w["limits"], **got}), flush=True)


if __name__ == "__main__":
    main()
