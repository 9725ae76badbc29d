"""The multi-rank dry run, the counterpart of ``dryrun_multichip`` in
__graft_entry__.py:73-251::

    torchrun --standalone --nproc_per_node=N \\
        -m nerf_replication_tpu_torch.parallel.dryrun [--device cpu]

On a process group of N ranks, at the JAX dry run's shapes (the lego 8x256
NeRF, 16 + 16 samples, 64 rays a step, 4 random 8x8 images, 2 steps), it
checks the data-parallel path against the same work on one rank, which
every rank also runs by itself:

* f32 arm (``network.dtype float32``, the ``nn.Module`` MLP: the fused
  kernels take bf16 products): per-step losses within rtol 1e-4, the
  largest parameter difference < 3e-3 (Adam's first steps are ~lr x
  sign(g), so reassociation noise on a near-zero gradient moves a
  parameter by up to a few lr), the dense eval of image 0 within 1e-3, the
  compacted frame and the NGP frame-path frame (a 3-level brick grid, W 16:
  outside the fused NGP kernel, so its unfused route) within 5e-2;
* bf16 arm (``network.dtype bfloat16`` through the fused training
  kernels, which the JAX dry run pins away, :109-111): per-step losses
  within :data:`BF16_LOSS_RTOL`, and two faulty ranks must fall outside
  it: one that sums the gradients without dividing by the group's size and
  one that skips the all-reduce (:data:`CONTROLS`);
* both arms: the first step's gradient as the optimizer takes it (after
  the all-reduce) against one rank's, within :data:`GRAD_TOL` of each
  tensor's largest magnitude, and both faulty ranks outside it. The loss
  stats ride in the gradients' buffer, so a sum without division doubles
  the logged loss too; the gradient check holds the gradients themselves,
  which Adam's update hardly tells from doubled ones.

Rank 0 prints one line in ``MULTICHIP_r05.json``'s format, then the bf16
arm's. A failed check raises.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import math
import os
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..config import CN, default_cfg, load_cfg_tree
from ..datasets.pipeline import DeviceRayPipeline
from ..models.nerf.network import make_network
from ..models.nerf.renderer import ngp_renderer
from ..models.nerf.renderer.volume_renderer import Renderer, RenderSettings
from ..train.trainers.trainer import make_trainer
from .mesh import Mesh, RowGenerator, make_dp_epoch_runner, make_mesh

ROOT = Path(__file__).resolve().parents[2]
LOSS_RTOL = 1e-4          # f32 per-step losses, N ranks against one
PARAM_MAX_DIFF = 3e-3
EVAL_MAX_DIFF = 1e-3
FRAME_MAX_DIFF = 5e-2
# bf16 per-step losses, N ranks against one: 2 ranks read 0 on the CPU and
# 1.56e-7 on the H100 (each ray's bf16 products are the one-rank run's; the
# means are summed in another order); the faulty ranks read 1.0 (the sum
# without division) and 5.0e-2 / 5.3e-2 (no all-reduce: the rank's own
# half of the batch), CPU / H100
BF16_LOSS_RTOL = 1e-5
# the first step's gradients, N ranks against one, the worst tensor's
# largest difference over its largest magnitude: 2 ranks read 9.3e-7 (f32)
# and 6.2e-7 (bf16) on the CPU, 5.4e-7 and 1.9e-6 on the H100; the faulty
# ranks 1.0 (the sum without division: every gradient doubled) and 2.3 /
# 1.3 (no all-reduce), CPU / H100
GRAD_TOL = 1e-5
N_STEPS = 2


class _SumMesh(Mesh):
    """A rank that sums the gradients without dividing."""

    def mean_(self, flat):
        return self.sum_(flat)


class _LocalMesh(Mesh):
    """A rank that skips the all-reduce."""

    def mean_(self, flat):
        return flat


class _OwnRows(RowGenerator):
    def draw(self, sample, shape):
        return sample(shape, self.generator)


class _OwnDrawsMesh(Mesh):
    """Ranks that draw their own rays: each draws its share's shape alone
    from the common generator, instead of its rows of the global draw."""

    def row_generator(self, generator, n):
        rg = super().row_generator(generator, n)
        return None if rg is None else _OwnRows(rg.generator, rg.index,
                                                rg.total)


# faulty ranks that a data-parallel check must see
CONTROLS = {"sum without division": _SumMesh, "no all-reduce": _LocalMesh,
            "own draws": _OwnDrawsMesh}


def control_mesh(mesh: Mesh, name: str) -> Mesh:
    """``mesh`` with the fault ``name`` of :data:`CONTROLS`."""
    return CONTROLS[name](mesh.rank, mesh.size, mesh.device, mesh.backend)


def _check(ok: bool, msg: str):
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def dryrun_cfg(dtype: str, device: str):
    """The JAX dry run's config: configs/nerf/lego.yaml at 16 + 16 samples,
    64 rays a step and a 64-ray eval chunk, ``network.dtype`` ``dtype``
    (float32 through the nn.Module MLP, bfloat16 through the fused
    kernels)."""
    cfg = load_cfg_tree(str(ROOT / "configs/nerf/lego.yaml"), default_cfg())
    cfg.task_arg.N_samples = 16
    cfg.task_arg.N_importance = 16
    cfg.task_arg.N_rays = 64
    cfg.task_arg.ray_chunk = 64
    cfg.ep_iter = N_STEPS
    cfg.device = device
    cfg.network.dtype = dtype
    cfg.network.use_pallas_mlp_train = dtype == "bfloat16"
    return cfg


def dryrun_pipeline(device) -> DeviceRayPipeline:
    """4 uniform random 8x8 images (seed 0), cameras at z = 4, focal 8."""
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(4, 8, 8, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    poses[:, 2, 3] = 4.0
    K = np.array([[8.0, 0, 4.0], [0, 8.0, 4.0], [0, 0, 1.0]], np.float32)
    return DeviceRayPipeline(images, poses, K, n_rays=64, device=device)


def record_first_grads(trainer) -> list:
    """A list that ``trainer``'s first optimizer step fills with a copy of
    every gradient it takes (after the all-reduce, before the clip)."""
    got, step = [], trainer.optimizer.step

    def recording_step():
        if not got:
            got.extend(p.grad.detach().clone()
                       for p in trainer.optimizer.params
                       if p.grad is not None)
        step()

    trainer.optimizer.step = recording_step
    return got


def grad_rel(grads: list, ref: list) -> float:
    """The worst tensor's largest difference from ``ref``'s over ``ref``'s
    largest magnitude."""
    worst = 0.0
    for g, r in zip(grads, ref, strict=True):
        d, m = float((g - r).abs().max()), float(r.abs().max())
        worst = max(worst, d / m if m else (0.0 if d == 0 else math.inf))
    return worst


def train_arm(cfg, mesh: Mesh | None, pipeline, net) -> tuple:
    """``N_STEPS`` steps of a copy of ``net`` (data-parallel over ``mesh``,
    or alone): ``(per-step losses, trained network, first step's
    gradients)``."""
    net = copy.deepcopy(net)
    trainer = make_trainer(cfg, net, mesh=mesh)
    grads = record_first_grads(trainer)
    with contextlib.redirect_stdout(io.StringIO()):
        if mesh is None:
            summary = trainer.train_device(0, pipeline, n_steps=N_STEPS)
        else:
            summary = make_dp_epoch_runner(trainer, pipeline, mesh,
                                           N_STEPS)(0)
    return summary["loss"], net, grads


@torch.no_grad()
def _max_param_diff(a, b) -> float:
    return max(float((p - q).abs().max())
               for p, q in zip(a.parameters(), b.parameters()))


def _loss_rel(losses, ref) -> float:
    return float(np.max(np.abs(np.asarray(losses) - ref) / np.abs(ref)))


def ngp_frame_net(device):
    """The JAX dry run's NGP network: 3 brick levels (4 -> 16, 2 features,
    ``log2_bricks`` 4), degree-2 SH, D 2 / W 16, f32."""
    cfg = CN({"task_arg": {"use_viewdirs": True},
              "network": {"dtype": "float32",
                          "nerf": {"W": 16, "D": 2, "V_D": 1, "skips": [1]},
                          "xyz_encoder": {
                              "type": "cuda_hashgrid", "backend": "brick",
                              "input_dim": 3, "num_levels": 3,
                              "level_dim": 2, "base_resolution": 4,
                              "desired_resolution": 16, "log2_bricks": 4,
                              "bounds": [-1.2, -1.2, -1.2, 1.2, 1.2, 1.2]},
                          "dir_encoder": {"type": "sphere_harmonics",
                                          "degree": 2}}})
    return make_network(cfg).to(device).eval()


def frames(mesh: Mesh, net_dp, net_1, settings) -> tuple[float, float]:
    """The compacted frame and the NGP frame-path frame of an 8x8 camera at
    z = 4 over an all-occupied 8^3 grid, sharded over ``mesh`` against one
    rank: ``(frame_diff, ngp_frame_diff)``."""
    H = W = 8
    focal = 0.5 * W / np.tan(0.3)
    c2w = torch.eye(4, device=mesh.device)
    c2w[2, 3] = 4.0
    grid = torch.ones((8, 8, 8), dtype=torch.uint8, device=mesh.device)
    occ = (grid, (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5), 2)
    kw = dict(capacity=0.75, occupancy=occ, out_dtype=torch.float32)
    f_1 = Renderer(net_1, settings=settings, mesh=None) \
        .make_frame_renderer(H, W, focal, **kw)(c2w)
    f_dp = Renderer(net_dp, settings=settings, mesh=mesh) \
        .make_frame_renderer(H, W, focal, **kw)(c2w)
    ngp = ngp_frame_net(mesh.device)
    apply_fn = ngp_renderer.make_ngp_eval_apply(ngp, fused=False)
    ngp_kw = dict(n_candidates=8, n_coarse=6, n_fine=6, capacity=0.75,
                  probe_sub=1, out_dtype=torch.float32, occ_capacity=0.75)
    s = RenderSettings(ray_chunk=32)
    g_1 = ngp_renderer.make_ngp_frame_renderer(apply_fn, H, W, focal, occ, s,
                                               **ngp_kw)(c2w)
    g_dp = ngp_renderer.make_ngp_frame_renderer(apply_fn, H, W, focal, occ,
                                                s, mesh=mesh, **ngp_kw)(c2w)
    return (float((f_dp - f_1).abs().max()),
            float((g_dp - g_1).abs().max()))


def dryrun_multichip(n_ranks: int, device: str = "cuda") -> dict:
    """The dry run on this process's group of ``n_ranks`` (the group is
    made from the environment if it is not yet). Returns the readings; a
    failed check raises."""
    mesh = make_mesh(n_devices=n_ranks, device=device)
    pipeline = dryrun_pipeline(mesh.device)

    # f32: training, eval, frames
    cfg = dryrun_cfg("float32", device)
    net = make_network(cfg).to(mesh.device)
    losses, net_dp, g_dp = train_arm(cfg, mesh, pipeline, net)
    losses_1, net_1, g_1 = train_arm(cfg, None, pipeline, net)
    _check(np.all(np.isfinite(losses)), f"non-finite loss {losses}")
    np.testing.assert_allclose(losses, losses_1, rtol=LOSS_RTOL, err_msg=(
        "sharded per-step losses diverge from one rank"))
    grad_diff = grad_rel(g_dp, g_1)
    _check(grad_diff <= GRAD_TOL, f"first-step gradient {grad_diff:.3e} "
           f"from one rank's (bound {GRAD_TOL})")
    max_diff = _max_param_diff(net_dp, net_1)
    _check(max_diff < PARAM_MAX_DIFF, f"max param diff {max_diff:.3e}")
    settings = RenderSettings.from_cfg(cfg)
    ro, rd = pipeline.rays_for_pose(pipeline.poses[0])
    img_dp = Renderer(net_dp, settings=settings, mesh=mesh) \
        .render_rays_batch(ro, rd)["rgb"]
    img_1 = Renderer(net_1, settings=settings, mesh=None) \
        .render_rays_batch(ro, rd)["rgb"]
    eval_diff = float((img_dp - img_1).abs().max())
    _check(eval_diff < EVAL_MAX_DIFF, f"sharded eval diff {eval_diff:.3e}")
    frame_diff, ngp_diff = frames(mesh, net_dp, net_1, settings)
    _check(frame_diff < FRAME_MAX_DIFF, f"frame diff {frame_diff:.3e}")
    _check(ngp_diff < FRAME_MAX_DIFF, f"NGP frame diff {ngp_diff:.3e}")

    # bf16: the fused training kernels, and the faulty ranks
    cfg16 = dryrun_cfg("bfloat16", device)
    net16 = make_network(cfg16).to(mesh.device)
    ref16, _, g16_1 = train_arm(cfg16, None, pipeline, net16)
    losses16, _, g16 = train_arm(cfg16, mesh, pipeline, net16)
    rel16 = _loss_rel(losses16, ref16)
    _check(rel16 <= BF16_LOSS_RTOL, f"bf16 per-step losses {rel16:.3e} "
           f"from one rank's (bound {BF16_LOSS_RTOL})")
    grad16 = grad_rel(g16, g16_1)
    _check(grad16 <= GRAD_TOL, f"bf16 first-step gradient {grad16:.3e} "
           f"from one rank's (bound {GRAD_TOL})")
    controls, control_grads = {}, {}
    for name in ("sum without division", "no all-reduce"):
        bad, _, g_bad = train_arm(cfg16, control_mesh(mesh, name), pipeline,
                                  net16)
        controls[name] = _loss_rel(bad, ref16)
        control_grads[name] = grad_rel(g_bad, g16_1)
        _check(controls[name] > BF16_LOSS_RTOL,
               f"the bf16 loss bound accepts a rank with {name}")
        _check(control_grads[name] > GRAD_TOL,
               f"the gradient bound accepts a rank with {name}")
    out = {"n_ranks": mesh.size, "loss": float(losses[-1]),
           "max_param_diff": max_diff, "eval_diff": eval_diff,
           "frame_diff": frame_diff, "ngp_frame_diff": ngp_diff,
           "grad_diff": grad_diff, "bf16_loss": float(losses16[-1]),
           "bf16_loss_rel": rel16, "bf16_grad_diff": grad16,
           "bf16_controls": controls, "bf16_control_grads": control_grads}
    if mesh.is_main:
        print(f"dryrun_multichip({mesh.size}): ok, loss={out['loss']:.5f}, "
              f"max_param_diff={max_diff:.2e}, eval_diff={eval_diff:.2e}, "
              f"frame_diff={frame_diff:.2e}, ngp_frame_diff={ngp_diff:.2e}"
              f", grad_diff={grad_diff:.2e}")
        print(f"dryrun_multichip({mesh.size}) bf16: ok, loss="
              f"{out['bf16_loss']:.5f}, max_loss_rel_diff={rel16:.2e} "
              f"(bound {BF16_LOSS_RTOL:.0e}), grad_diff={grad16:.2e} "
              f"(bound {GRAD_TOL:.0e}), controls (loss, gradient): "
              + ", ".join(f"{k} {v:.2e}, {control_grads[k]:.2e}"
                          for k, v in controls.items()))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    try:
        dryrun_multichip(int(os.environ.get("WORLD_SIZE", "1")), args.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
