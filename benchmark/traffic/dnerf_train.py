"""D-NeRF training traffic: a closed loop of ``Trainer.train_device`` epochs
of the port's D-NeRF (a deformation MLP ahead of the canonical 8x256 NeRF)
on the device-resident ray pipeline, every ray at its view's time, from an
initialisation drawn from the seed.

Set-up makes the dynamic scene's train views on the device
(``harness/dnerf_scene.py``: view i of n at time i / (n - 1)), builds the
port's network, trainer and pipeline from the configuration, loads the
benchmark's initial weights and drives the run's start through the
window's own call, as ``traffic/train.py`` does: the window, the traced
pass and the two checked stretches (the start and the first whole epoch at
or past ``precrop_iters``, followed from the program's state) are that
file's, and so are the numbers of ``train.compare``. The reference is
``benchmark/reference/dnerf.py``, trained on the same draws: the image,
the pixels, the coarse jitter and the fine ``u`` from one generator an
epoch in the program's order (``reference/render.py``'s ``train_batch``),
each ray at its image's time.

The deformation's numbers are added (:func:`dnerf_compare`):
``deform_grad_angle``, 1 - cos of the deformation MLP's first gradient
with the reference's, which reads the canonical MLP's input gradient (the
deformation's one way to learn) by its direction; ``deform_step_gap``,
the gap of its whole change's norm over each stretch, 1 where it never
moves (its input gradient lost, dx dropped, a state unchanged);
``grad_diff.canonical``, the median leaf's first-gradient difference over
the canonical MLP's leaves alone; and ``time_gap``, the largest
difference between the times the program's pipeline gave the start's
rays and the reference's (each ray's image's).
The numbers past the first step (``loss_med``, ``loss_gap``, ``step_gap``)
are chaotic and not compared: Adam moves dx, and the 10th band turns 1e-3
of dx into 0.5 rad, so a float32 reference from weights one unit in the
last place away parts from the reference as far as the program does (the
``ulp`` witness; PERF.md section 4). The
first gradient of the deformation is a small remainder of large
per-point terms that cancel, so rounding its products to bf16, as the
configuration states, moves it by about its own size (the
``deform_bf16`` witness): it is held by its direction, not leaf by leaf.

Run as a module, it prints the readings of the cell's control and faults
for setting its limits, one JSON line a seed:

    python -m benchmark.traffic.dnerf_train --seeds 11 12 13
"""

from __future__ import annotations

import argparse
import json
import math
import os

import torch

from benchmark.harness import core, dnerf_scene, dnerf_yardstick, inputs, port
from benchmark.reference import dnerf as ref_dnerf
from benchmark.reference import field as ref_field
from benchmark.reference import render as ref_render
from benchmark.traffic import train as train_traffic
from benchmark.traffic.train import compare, late_epoch

UNITS = train_traffic.UNITS


def views(p: dict, device) -> dict:
    """The cell's train views on ``device``: uint8 ``images``, ``alphas``,
    ``poses`` (n, 4, 4), ``K`` (3, 3), ``times`` (n,)."""
    images, alphas, poses, K, times = dnerf_scene.train_views(
        p["views"], p["H"], p["W"], device)
    return {"images": images, "alphas": alphas,
            "poses": torch.as_tensor(poses, device=device),
            "K": torch.as_tensor(K), "times": torch.as_tensor(times,
                                                              device=device)}


def half_batch_loss(field, w, rays_o, rays_d, times, colors, r, gen):
    """The fault: the loss's mean taken over the first half of the rays."""
    h = rays_o.shape[0] // 2
    return ref_dnerf.loss_of(field, w, rays_o[:h], rays_d[:h], times[:h],
                             colors[:h], r, gen)


def train_steps(field, w: dict, data: dict, r: dict, train: dict, seed: int,
                epochs, state: dict | None = None,
                loss_of=ref_dnerf.loss_of) -> dict:
    """``reference/render.py``'s ``train_steps`` for a D-NeRF field: each
    step's batch is ``train_batch``'s, and each of its rays is at its
    image's time (the image drawn first, read here from a copy of the
    generator's state). ``loss_of`` is the reference's loss, or a
    fault's."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in w.items()}
    state = state or {}
    opt = ref_render.Adam(params, train, state.get("m"), state.get("v"),
                          state.get("t", 0))
    r = {**r, **train}
    dev = data["images"].device
    n_img = data["images"].shape[0]
    losses, first, step_times = [], None, []
    for epoch, n_steps in epochs:
        gen = torch.Generator(device=dev).manual_seed(
            ref_render.epoch_seed(seed, epoch))
        for _ in range(n_steps):
            peek = gen.get_state()
            img = torch.randint(0, n_img, (), generator=gen, device=dev)
            gen.set_state(peek)
            rays_o, rays_d, colors, _ = ref_render.train_batch(
                data, gen, opt.t, r, False)
            times = data["times"][img].expand(rays_o.shape[0])
            step_times.append(times)
            loss = loss_of(field, params, rays_o, rays_d, times, colors, r,
                           gen)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
            grads = {k: (torch.zeros_like(p) if g is None else g)
                     for (k, p), g in zip(params.items(), grads)}
            if first is None:
                first = {k: g.clamp(-train["clip"], train["clip"])
                         for k, g in grads.items()}
            opt.step(params, grads)
            losses.append(loss.item())
    return {"losses": losses, "first": first, "times": step_times,
            "weights": {k: v.detach() for k, v in params.items()},
            "state": {"m": opt.m, "v": opt.v, "t": opt.t}}


def angle(a: torch.Tensor, b: torch.Tensor) -> float:
    """1 - cos(a, b): 0 where they point one way, 1 at right angles or where
    one is zero and the other is not, 2 where they point opposite ways; 0
    where both are zero (the first step's view at the canonical time).
    In float64."""
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    na, nb = float(a.norm()), float(b.norm())
    if na == 0.0 or nb == 0.0:
        return 0.0 if na == nb else 1.0
    return 1.0 - float(a @ b) / (na * nb)


def dnerf_compare(ref: dict, got: dict, w0: dict, w_late: dict) -> dict:
    """``train.compare``'s numbers and the deformation's:

    * ``deform_grad_angle``: :func:`angle` of the deformation MLP's first
      gradient (its leaves as one vector) with the reference's. It is the
      one number that reads the canonical MLP's input gradient by its
      direction: under Adam the change's norm hardly depends on it;
    * ``deform_step_gap``: the gap of its change's norm over each stretch
      from the reference's, over the reference's (the worse stretch; each
      logged); 1 where it never moves;
    * ``time_gap``: the largest gap of the start's rays' times;
    * ``grad_diff.canonical`` and ``grad_diff.deform``: the median leaf's
      first-gradient difference over each MLP's leaves alone. The
      canonical MLP's is steady (Psi_t's rounding hardly reaches it) and
      sees half a batch, where ``grad_diff_med``, whose median the
      deformation's leaves pull up, does not.

    ``got["start"]`` holds the ``times`` of its steps' rays."""
    out = compare(ref, got, w0, w_late)
    keys = [k for k in ref["start"]["first"] if k.startswith("deform.")]

    def flat(tree):
        return torch.cat([tree[k].double().reshape(-1) for k in keys])

    def ratio(num, den):
        """num / den; 0 where both are 0, infinite where den alone is."""
        if den == 0.0:
            return 0.0 if num == 0.0 else math.inf
        return num / den

    for part, base in (("start", w0), ("late", w_late)):
        if got[part] is None:
            out[f"deform_step_gap.{part}"] = float("inf")
            continue
        step = flat(got[part]["weights"]) - flat(base)
        want = flat(ref[part]["weights"]) - flat(base)
        out[f"deform_step_gap.{part}"] = ratio(
            abs(float(step.norm()) - float(want.norm())), float(want.norm()))
    out["deform_step_gap"] = max(out["deform_step_gap.start"],
                                 out["deform_step_gap.late"])
    g, r_g = got["start"]["first"], ref["start"]["first"]
    out["deform_grad_angle"] = angle(flat(g), flat(r_g))
    out["time_gap"] = max(float((a - b).abs().max()) for a, b in zip(
        got["start"]["times"], ref["start"]["times"], strict=True))
    for group in ("deform", "canonical"):
        leaves = [k for k in r_g if k.startswith(group + ".")]
        diff = train_traffic.norms({k: g[k] - r_g[k] for k in leaves})
        n_ref = train_traffic.norms({k: r_g[k] for k in leaves})
        floor = train_traffic.median(n_ref.values())
        out[f"grad_diff.{group}"] = train_traffic.median(
            ratio(diff[k], max(n, floor)) for k, n in n_ref.items())
    return out


class Cell(train_traffic.Cell):
    """``traffic/train.py``'s cell on the D-NeRF's inputs and network."""

    def __init__(self, ctx: core.Context):
        from nerf_replication_tpu_torch.models import make_network
        from nerf_replication_tpu_torch.train import make_trainer
        from nerf_replication_tpu_torch.train.cli import make_pipeline

        self.ctx = ctx
        p, c, dev = ctx.params, ctx.config, ctx.device
        self.n_call = int(p["steps_per_call"])
        self.cfg = port.cfg(c, dev, seed=ctx.seed)
        with ctx.stage("views"):
            self.data = views(p, dev)
        with ctx.stage("network, trainer, pipeline"):
            self.w0 = inputs.init_weights(
                dnerf_yardstick.weight_shapes(c["model"]), c["model"],
                ctx.seed, dev)
            network = make_network(self.cfg).to(dev)
            network.load_state_dict(self.w0, strict=True)
            self.trainer = make_trainer(self.cfg, network)
            d = self.data
            self.pipeline = make_pipeline(
                self.cfg, (d["images"].cpu().numpy(), d["poses"].cpu().numpy(),
                           d["K"].numpy(), d["alphas"].cpu().numpy(),
                           d["times"].cpu().numpy()), dev)
        self.network = network
        self.epoch = 0
        self.late = None
        # the times the pipeline gives the start's rays, kept as they are
        # drawn (set-up only: the window's steps are not wrapped)
        times, sample = [], self.pipeline.sample

        def recorded(gen, step=1 << 30):
            batch = sample(gen, step)
            times.append(batch["times"])
            return batch

        self.pipeline.sample = recorded
        with ctx.stage("checked start"):
            losses = list(self._epoch(1)["loss"])
            first = self._adam_state()["m"]
            b1 = self._beta1()
            first = {k: m / (1.0 - b1) for k, m in first.items()}
            losses += list(self._epoch(self.n_call)["loss"])
        del self.pipeline.sample
        self.start = {"losses": [float(x) for x in losses], "first": first,
                      "weights": self._weights(), "times": times}

    def checks(self) -> list:
        ctx, c = self.ctx, self.ctx.config
        epoch, step = late_epoch(c["train"]["precrop_iters"], self.n_call)
        for _ in range(epoch):      # enough for a run whose steps count
            if self.late is not None:
                break
            self._epoch(self.n_call)
        del self.trainer, self.pipeline, self.network
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        field = ref_dnerf.DNeRFField(c["model"])

        def train(w, epochs, state=None):
            return train_steps(field, w, self.data, c["render"], c["train"],
                               ctx.seed, epochs, state)

        if self.late is None:       # the reference's own state stands in
            start = train(self.w0, [(0, 1), (1, self.n_call)])
            self.late = {"epoch": epoch, "losses": None,
                         "begin": {**start["state"], "t": step,
                                   "weights": start["weights"]}}
        begin = self.late["begin"]
        ref = {"start": train(self.w0, [(0, 1), (1, self.n_call)]),
               "late": train(begin["weights"],
                             [(self.late["epoch"], self.n_call)], begin)}
        got = {"start": self.start,
               "late": None if self.late["losses"] is None else self.late}
        return core.checks(ctx, dnerf_compare(ref, got, self.w0,
                                              begin["weights"]))


def control_readings(w: dict, c: dict, seed: int, device,
                     data: dict) -> dict:
    """The readings of the cell's control, faults and witnesses, each a
    stand-in for the program compared with the float32 reference as a run
    compares the program: ``control`` (the reference in the precision
    below the configuration's); the faults ``half_batch`` (the loss's mean
    over half of the rays), ``no_deform`` (dx dropped), ``no_input_grad``
    (the canonical MLP's input gradient zeroed: the deformation never
    learns), ``flip_input_grad`` (its sign flipped), ``no_skip_grad`` (its
    product through the re-joined input left out), ``shuffled_times``
    (every view at the time of the view half the split away: the
    stand-in's rays carry those times) and ``unchanged`` (a state the
    steps leave as it was); the input gradient's two faults again on
    ``deform_bf16``'s base (``<fault>.deform_bf16``: as the program would
    read with them); the witnesses ``deform_bf16`` (the reference with
    Psi_t's products alone rounded to bfloat16, as the program's are) and
    ``ulp`` (the float32 reference from weights one unit in the last place
    away). Each stand-in trains the start from the seed's
    weights and its late epoch from the float32 reference's state after
    the start, as ``tools/controls.py`` does for the other training
    cells."""
    n = w["params"]["steps_per_call"]
    w0 = inputs.init_weights(dnerf_yardstick.weight_shapes(c["model"]),
                             c["model"], seed, device)
    epoch, step = late_epoch(c["train"]["precrop_iters"], n)

    def run(prec="float32", fault=None, times=None, begin=None,
            loss_of=ref_dnerf.loss_of, deform_prec=None, start_w=w0):
        field = ref_dnerf.DNeRFField(c["model"], ref_field.Precision(prec),
                                     fault, deform_prec)
        d = data if times is None else {**data, "times": times}
        start = train_steps(field, start_w, d, c["render"], c["train"],
                            seed, [(0, 1), (1, n)], loss_of=loss_of)
        begin = begin or {**start["state"], "weights": start["weights"],
                          "t": step}
        late = train_steps(field, begin["weights"], d, c["render"],
                           c["train"], seed, [(epoch, n)], begin,
                           loss_of=loss_of)
        return {"start": start, "late": late}, begin

    def ulp(tree):
        return {k: torch.nextafter(v, torch.full_like(v, math.inf))
                for k, v in tree.items()}

    ref, begin = run()
    w_late = begin["weights"]
    shifted = data["times"].roll(data["times"].shape[0] // 2)
    out = {"control": run(c["precision"]["control"], begin=begin)[0],
           "half_batch": run(loss_of=half_batch_loss, begin=begin)[0]}
    for fault in ("no_deform", "no_input_grad", "flip_input_grad",
                  "no_skip_grad"):
        out[fault] = run(fault=fault, begin=begin)[0]
    for fault in ("flip_input_grad", "no_skip_grad"):
        out[f"{fault}.deform_bf16"] = run(fault=fault, deform_prec="bfloat16",
                                          begin=begin)[0]
    out["shuffled_times"] = run(times=shifted, begin=begin)[0]
    out["unchanged"] = {"start": {**ref["start"], "weights": w0},
                        "late": {**ref["late"], "weights": w_late}}
    out["deform_bf16"] = run(deform_prec="bfloat16", begin=begin)[0]
    out["ulp"] = run(start_w=ulp(w0), begin={
        **begin, "weights": ulp(begin["weights"])})[0]
    return {k: dnerf_compare(ref, got, w0, w_late)
            for k, got in out.items()}


def main(argv=None):
    from benchmark.harness import specs

    parser = argparse.ArgumentParser(description="the cell's control and "
                                     "fault readings")
    parser.add_argument("--workload", default="dnerf-train")
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    os.chdir(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    w = specs.workload(args.workload)
    c = specs.config(w["config"])
    data = views(w["params"], device)
    for seed in args.seeds:
        got = control_readings(w, c, seed, device, data)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "limits": w["limits"], **got}), flush=True)


if __name__ == "__main__":
    main()
