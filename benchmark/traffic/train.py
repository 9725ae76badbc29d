"""Training traffic: a closed loop of ``Trainer.train_device`` epochs on
the device-resident ray pipeline, from an initialisation drawn from the
seed.

Set-up makes the scene's train views on the device, builds the port's
network, trainer and pipeline from the configuration, loads the
benchmark's initial weights, and drives the run's start through the
window's own call: a one-step epoch (its gradient is read from Adam's
first moment), then one epoch of ``steps_per_call`` steps, which also
warms every shape. The window runs whole ``steps_per_call``-step epochs
from a synchronised card until ``--seconds`` have passed;
``train_rays_per_s`` is every ray trained over the window's wall time.

Two stretches are checked against the plain reference, which trains the
same steps on the same draws (one generator an epoch, as the trainer
draws them):

* the start: the first 1 + ``steps_per_call`` steps, from the seed's
  weights, in the centre crop at the first learning rate;
* a late epoch: the first ``steps_per_call``-step epoch that starts at or
  past ``precrop_iters``, so whole-image draws under the scheduled
  learning rate. The reference follows it from the program's own state
  at its start (weights, Adam's moments and step count), read in the
  window: a bfloat16 program and a float32 reference part ways over
  hundreds of steps, so the steps between are not followed; they run
  the start's code in the crop. Where the window ends before that epoch,
  more epochs run after it until it is done.

The numbers (:func:`compare`; a cell's ``limits`` name those it
compares): the worst step's loss gap, over both stretches, and the
median step's over the start; the worst leaf's gap of norms of the first
gradient, and of the change over each stretch; the median leaf's norm of
the first gradient's difference. Each leaf's is taken over the
reference's norm of that leaf or of the median leaf, whichever is
larger.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark.harness import core, inputs, port, yardstick
from benchmark.reference import field as ref_field
from benchmark.reference import render as ref_render

UNITS = {"train_rays_per_s": "rays/s"}


def norms(tree: dict) -> dict:
    return {k: float(torch.linalg.norm(v.double())) for k, v in tree.items()}


def median(xs) -> float:
    return float(torch.tensor(list(xs), dtype=torch.float64).median())


def per_leaf(num: dict, ref: dict) -> list[float]:
    """Each leaf's ``num`` over max(its reference norm, the median leaf's
    reference norm): some gradients are all but zero."""
    n_ref = norms(ref)
    med = median(n_ref.values())
    return [num[k] / max(n, med) for k, n in n_ref.items()]


def moved_leaves(grads: dict) -> set:
    """Leaves whose reference gradient is above a thousandth of the median
    leaf's: the others move under Adam by round-off alone."""
    n = norms(grads)
    med = median(n.values())
    return {k for k, v in n.items() if v > 1e-3 * med}


def late_epoch(precrop_iters: int, steps_per_call: int) -> tuple[int, int]:
    """(epoch, first global step) of the late checked epoch when the run
    trains epoch 0 of one step and then ``steps_per_call``-step epochs."""
    epoch = 1 + max(0, -(-(precrop_iters - 1) // steps_per_call))
    return epoch, 1 + (epoch - 1) * steps_per_call


def compare(ref: dict, got: dict, w0: dict, w_late: dict) -> dict:
    """A training check's numbers. ``ref`` and ``got`` (the program's, or a
    stand-in's) each hold ``start`` (``losses``, ``first`` gradients,
    ``weights`` after) and ``late`` (``losses``, ``weights`` after); the
    start trains from ``w0``, the late epoch from ``w_late``; a ``late``
    of None (a run whose step count never reached it) reads infinite.
    The worst-step and worst-leaf numbers take the worse stretch; each
    stretch's is logged beside them. ``loss_med``, the median step's loss
    gap over the start, is steady from seed to seed where the worst
    step's swings."""
    keep = moved_leaves(ref["start"]["first"])

    def loss_gaps(part):
        return [abs(a - b) / abs(b) for a, b in
                zip(got[part]["losses"], ref[part]["losses"])]

    def step_gap(part, base):
        step, r_step = ({k: s[part]["weights"][k] - base[k] for k in keep}
                        for s in (got, ref))
        n_s, n_rs = norms(step), norms(r_step)
        return max(per_leaf({k: abs(n_s[k] - n_rs[k]) for k in n_rs},
                            r_step))

    g, r_g = got["start"]["first"], ref["start"]["first"]
    n_g, n_rg = norms(g), norms(r_g)
    diff = norms({k: g[k] - v for k, v in r_g.items()})
    late = got["late"] is not None     # None: the run never got there
    start = loss_gaps("start")
    out = {"loss_gap.start": max(start),
           "loss_gap.late": max(loss_gaps("late")) if late else math.inf,
           "loss_med": median(start),
           "step_gap.start": step_gap("start", w0),
           "step_gap.late": step_gap("late", w_late) if late else math.inf,
           "grad_gap": max(per_leaf({k: abs(n_g[k] - n_rg[k])
                                     for k in n_rg}, r_g)),
           "grad_diff_med": median(per_leaf(diff, r_g))}
    out["loss_gap"] = max(out["loss_gap.start"], out["loss_gap.late"])
    out["step_gap"] = max(out["step_gap.start"], out["step_gap.late"])
    return out


class Cell:
    def __init__(self, ctx: core.Context):
        from nerf_replication_tpu_torch.models import make_network
        from nerf_replication_tpu_torch.train import make_trainer
        from nerf_replication_tpu_torch.train.cli import make_pipeline

        self.ctx = ctx
        p, c, dev = ctx.params, ctx.config, ctx.device
        self.n_call = int(p["steps_per_call"])
        self.cfg = port.cfg(c, dev, seed=ctx.seed)
        with ctx.stage("views"):
            images, alphas, poses, K = inputs.train_views(
                p["views"], p["H"], p["W"], dev)
        self.data = {"images": images, "alphas": alphas,
                     "poses": torch.as_tensor(poses, device=dev),
                     "K": torch.as_tensor(K)}
        with ctx.stage("network, trainer, pipeline"):
            shapes = yardstick.weight_shapes(c["model"])
            self.w0 = inputs.init_weights(shapes, c["model"], ctx.seed, dev)
            network = make_network(self.cfg).to(dev)
            network.load_state_dict(self.w0, strict=True)
            self.trainer = make_trainer(self.cfg, network)
            self.pipeline = make_pipeline(
                self.cfg, (images.cpu().numpy(), poses, K,
                           alphas.cpu().numpy()), dev)
        self.network = network
        self.epoch = 0
        self.late = None
        with ctx.stage("checked start"):
            losses = list(self._epoch(1)["loss"])
            first = self._adam_state()["m"]
            b1 = self._beta1()
            first = {k: m / (1.0 - b1) for k, m in first.items()}
            losses += list(self._epoch(self.n_call)["loss"])
        self.start = {"losses": [float(x) for x in losses], "first": first,
                      "weights": self._weights()}

    def _epoch(self, n_steps: int) -> dict:
        """One ``train_device`` epoch; the first full epoch at or past
        ``precrop_iters`` is kept for the check, with the program's state
        at its start."""
        late = (self.late is None and n_steps == self.n_call
                and self.trainer.step >= self.ctx.config["train"]
                ["precrop_iters"])
        if late:
            begin = {"weights": self._weights(), **self._adam_state()}
        out = self.trainer.train_device(self.epoch, self.pipeline,
                                        n_steps=n_steps)
        if late:
            self.late = {"epoch": self.epoch, "begin": begin,
                         "losses": [float(x) for x in out["loss"]],
                         "weights": self._weights()}
        self.epoch += 1
        return out

    def _weights(self) -> dict:
        return {k: p.detach().clone()
                for k, p in self.network.named_parameters()}

    def _beta1(self) -> float:
        groups = self.trainer.optimizer.optimizer.param_groups
        (b1,) = {g["betas"][0] for g in groups}
        return b1

    def _adam_state(self) -> dict:
        """Adam's moments by leaf (zero before a leaf's first step) and
        its step count."""
        opt = self.trainer.optimizer
        m, v = {}, {}
        for name, p in self.network.named_parameters():
            s = opt.optimizer.state.get(p, {})
            m[name] = (s["exp_avg"].detach().clone() if "exp_avg" in s
                       else torch.zeros_like(p))
            v[name] = (s["exp_avg_sq"].detach().clone() if "exp_avg_sq" in s
                       else torch.zeros_like(p))
        return {"m": m, "v": v, "t": opt.count}

    def window(self, seconds: float) -> dict:
        port.sync(self.ctx.device)
        t0 = time.perf_counter()
        steps = 0
        while time.perf_counter() - t0 < seconds:
            steps += self._epoch(self.n_call)["steps"]
        wall = time.perf_counter() - t0
        return {"train_rays_per_s": steps * self.pipeline.n_rays / wall,
                "attempted": steps, "failed": 0, "wall_s": wall,
                "steps": steps}

    def profiled(self, count: int):
        return lambda: self._epoch(count)

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
        field = ref_field.Field(c["model"])
        if self.late is None:       # the reference's own state stands in
            start = ref_render.train_steps(
                field, self.w0, self.data, c["render"], c["train"],
                ctx.seed, [(0, 1), (1, self.n_call)])
            self.late = {"epoch": epoch, "losses": None,
                         "begin": {**start["state"], "t": step,
                                   "weights": start["weights"]}}
        begin = self.late["begin"]

        def train(w, epochs, state=None):
            return ref_render.train_steps(field, w, self.data, c["render"],
                                          c["train"], ctx.seed, epochs,
                                          state)

        ref = {"start": train(self.w0, [(0, 1), (1, self.n_call)]),
               "late": train(begin["weights"],
                             [(self.late["epoch"], self.n_call)], begin)}
        got = {"start": self.start,
               "late": None if self.late["losses"] is None else self.late}
        return core.checks(ctx, compare(ref, got, self.w0,
                                        begin["weights"]))
